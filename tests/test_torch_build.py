"""The kernel builder's macro variants and the sLSTM step-split builds, on
the CPU (nothing is compiled: the tests check names and hashes only)."""
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.slstm import step_split  # noqa: E402


def test_variant_library_names_hash_the_source_and_the_flags():
    src = build.SOURCES["slstm"]
    assert build.library_path("slstm") == build.variant_path(src)
    paths = {build.variant_path(src, flags) for _, flags in step_split.variants()}
    assert len(paths) == len(step_split.STAGES) == 4
    assert build.library_path("slstm") not in paths
    assert all(p.name.startswith("libslstm-") and p.parent == build.build_dir()
               for p in paths)


def test_step_split_builds_each_stage_of_the_given_source(tmp_path):
    other = tmp_path / "slstm.cu"
    other.write_text(build.SOURCES["slstm"].read_text() + "\n")
    got = step_split.variants(other)
    assert [flags for _, flags in got] == [(f"-DSLSTM_STAGES={n}",) for n in (1, 2, 3, 4)]
    assert all(src == other for src, _ in got)
    assert ({build.variant_path(s, f) for s, f in got}
            .isdisjoint({build.variant_path(s, f) for s, f in step_split.variants()}))


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_slstm_source_guards_every_stage(stage):
    """Each partial build's stages are guarded in the source, and the full
    kernel is stage 4 by default."""
    text = build.SOURCES["slstm"].read_text()
    assert "#define SLSTM_STAGES 4" in text
    assert f"SLSTM_STAGES >= {stage + 1}" in text


def test_step_split_refuses_without_a_card():
    code = ("import torch; torch.cuda.is_available = lambda: False\n"
            "import sys; sys.argv = ['step_split']\n"
            "from repro_torch.kernels.slstm import step_split; step_split.main()")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=Path(build.__file__).resolve().parents[2], timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
