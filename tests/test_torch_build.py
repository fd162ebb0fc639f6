"""The kernel builder's macro variants, the sLSTM step-split builds, the
AirComp sources' interfaces and their comparison script, on the CPU
(nothing is compiled: the tests check names, texts and hashes only)."""
import math
import re
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


@pytest.mark.parametrize("name", ["aircomp", "quant_aircomp", "sparse_aircomp"])
def test_aircomp_source_keeps_its_interface(name):
    """Each AirComp source defines ``<name>_launch`` and ``<name>_error_string``
    (what ``build.launch`` binds), a ``__global__ <name>_kernel`` in its
    anonymous namespace (what a trace is searched for by ``::<name>_kernel``)
    and includes no local header (a library is named by a hash of its
    ``.cu`` alone, so a changed header would load a stale build)."""
    text = build.SOURCES[name].read_text()
    assert re.search(rf"^int {name}_launch\(", text, re.M)
    assert re.search(rf"^const char\* {name}_error_string\(int code\)", text, re.M)
    anon = text[text.index("namespace {"):text.index("}  // namespace")]
    assert re.search(rf"__global__ void (__launch_bounds__\([^)]*\)\s*)?{name}_kernel\(",
                     anon)
    assert not re.search(r'^#include\s+"', text, re.M)


def test_aircomp_compare_pairs_each_source_with_its_kernel(tmp_path):
    from repro_torch.kernels.aircomp import compare
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    q1, q2 = tmp_path / "a" / "quant_aircomp.cu", tmp_path / "b" / "quant_aircomp.cu"
    sp = tmp_path / "a" / "sparse_aircomp.cu"
    got = compare.builds([q1, sp, q2])
    assert got == {"aircomp": [build.SOURCES["aircomp"]],
                   "quant_aircomp": [build.SOURCES["quant_aircomp"], q1, q2],
                   "sparse_aircomp": [build.SOURCES["sparse_aircomp"], sp]}
    with pytest.raises(ValueError, match="not a source"):
        compare.builds([tmp_path / "rmsnorm.cu"])


@pytest.mark.parametrize("name,rows,m,want", [
    ("quant_aircomp", 40, 7850, 2_575_120),
    ("sparse_aircomp", 40, 7850, 1_319_120),
    ("aircomp", 40, 7850, 1_318_960),
    ("quant_aircomp", 40, 2 ** 24 + 3, 5_502_928_152),
    ("sparse_aircomp", 40, 2 ** 24 + 3, 2_818_573_112),
])
def test_aircomp_compare_counts_the_bytes_of_the_bound(name, rows, m, want):
    from repro_torch.kernels.aircomp import compare
    assert compare.nbytes(name, rows, m) == want


@pytest.mark.parametrize("rows,m,want", [
    (40, 7850, 690_960),               # 40·7850·2 + 2·7850·4 + 40·4
    (40, 2 ** 24 + 3, 1_476_395_432),
])
def test_aircomp_compare_counts_bf16_rows_at_two_bytes(rows, m, want):
    from repro_torch.kernels.aircomp import compare
    assert compare.nbytes("aircomp", rows, m, x_bytes=2) == want
    assert compare.nbytes("aircomp", rows, m) - want == rows * m * 2


def test_aircomp_compare_cases_add_bf16_for_aircomp_only():
    """Every kernel runs the fixed cases and one [40, N] a ``--columns N`` in
    f32; aircomp runs each again with bf16 rows."""
    from repro_torch.kernels.aircomp import compare
    f32 = [("main", 40, 7850, "float32"), ("N100", 100, 7850, "float32"),
           ("large", 40, 2 ** 24 + 3, "float32"), ("M4096", 40, 4096, "float32")]
    for name in ("quant_aircomp", "sparse_aircomp"):
        assert compare.cases(name, [4096]) == f32
    assert compare.cases("aircomp", [4096]) == f32 + [
        (f"{case}_bf16", rows, m, "bfloat16") for case, rows, m, _ in f32]
    assert [c for c, *_ in compare.cases("aircomp")] == [
        "main", "N100", "large", "main_bf16", "N100_bf16", "large_bf16"]


@pytest.mark.parametrize("name", ["aircomp", "quant_aircomp", "sparse_aircomp"])
def test_aircomp_sources_switch_layouts_where_the_wrapper_says(name):
    """``kernel.NARROW_MAX_COLS``, which the card tests' edge cases use, is
    each source's ``kNarrowMaxCols``."""
    from repro_torch.kernels.aircomp.kernel import NARROW_MAX_COLS
    expr = re.search(r"constexpr int64_t kNarrowMaxCols = ([\d *]+);",
                     build.SOURCES[name].read_text()).group(1)
    assert math.prod(int(f) for f in expr.split("*")) == NARROW_MAX_COLS


def test_aircomp_source_switches_to_its_later_layouts_where_the_wrapper_says():
    """``kernel.AIRCOMP_LAYOUT_FIRST_COLS``, which the card tests' and
    chip_smoke's edge cases use, is one past ``kNarrowMaxCols`` and one past
    ``kColumnMaxCols`` (f32's multiple, bf16's) in aircomp.cu, whose
    ``run_layout`` switches at those two bounds."""
    from repro_torch.kernels.aircomp.kernel import (AIRCOMP_LAYOUT_FIRST_COLS,
                                                    NARROW_MAX_COLS)
    text = build.SOURCES["aircomp"].read_text()
    f32, bf16 = re.search(r"kColumnMaxCols = \(sizeof\(T\) == 4 \? (\d+) : (\d+)\) "
                          r"\* kNarrowMaxCols;", text).groups()
    assert AIRCOMP_LAYOUT_FIRST_COLS == {
        "float32": (NARROW_MAX_COLS + 1, int(f32) * NARROW_MAX_COLS + 1),
        "bfloat16": (NARROW_MAX_COLS + 1, int(bf16) * NARROW_MAX_COLS + 1)}
    body = text[text.index("int run_layout("):]
    assert re.findall(r"if \(m <= (\w+(?:<T>)?)\)", body) == [
        "kNarrowMaxCols", "kColumnMaxCols<T>"]


def test_aircomp_compare_refuses_without_a_card():
    code = ("import torch; torch.cuda.is_available = lambda: False\n"
            "import sys; sys.argv = ['compare']\n"
            "from repro_torch.kernels.aircomp import compare; compare.main()")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=Path(build.__file__).resolve().parents[2], timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
