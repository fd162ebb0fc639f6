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


def test_hmma_counts_reads_each_function_of_the_sass(monkeypatch):
    """``hmma_counts`` counts HMMA lines under each ``Function :`` header of
    cuobjdump's SASS listing (a function with none counts 0)."""
    sass = """
        Function : _Z5firstv
        /*0000*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*0010*/                   FFMA R1, R2, R3, R1 ;
        /*0020*/                   HMMA.16816.F32.BF16 R16, R8, R12, R16 ;
        Function : _Z6secondv
        /*0000*/                   FFMA R1, R2, R3, R1 ;
    """
    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout=sass)

    monkeypatch.setattr(build, "_toolkit", lambda tool: tool)
    monkeypatch.setattr(build.subprocess, "run", run)
    assert build.hmma_counts(Path("lib.so")) == {"_Z5firstv": 2, "_Z6secondv": 0}
    assert calls == [["cuobjdump", "-sass", "lib.so"]]
