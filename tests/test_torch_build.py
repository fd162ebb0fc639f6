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


def test_step_split_builds_the_backward_stages():
    """``--backward`` builds ``slstm_bwd.cu`` at SLSTM_BWD_STAGES 1..4,
    libraries apart from the forward's stages and from the kernel's own."""
    got = step_split.variants(backward=True)
    assert [flags for _, flags in got] == [(f"-DSLSTM_BWD_STAGES={n}",) for n in (1, 2, 3, 4)]
    assert all(src == build.SOURCES["slstm_bwd"] for src, _ in got)
    paths = {build.variant_path(s, f) for s, f in got}
    assert len(paths) == 4 and build.library_path("slstm_bwd") not in paths
    assert paths.isdisjoint({build.variant_path(s, f) for s, f in step_split.variants()})


def test_slstm_bwd_source_guards_every_stage():
    """The exchange, the products and the cell are each guarded, and the
    full kernel is stage 4 by default."""
    text = build.SOURCES["slstm_bwd"].read_text()
    assert "#define SLSTM_BWD_STAGES 4" in text
    for guard in ("SLSTM_BWD_STAGES >= 2", "SLSTM_BWD_STAGES >= 3", "SLSTM_BWD_STAGES < 4"):
        assert guard in text


@pytest.mark.parametrize("bhkv,group,t,want", [
    (16, 7, 128, 7),     # qwen2-0.5b's gather round: 32 dK/dV blocks, split over 7
    (16, 7, 2048, 1),    # the long shape: 512 blocks already fill the card
    (40, 2, 512, 1), (4, 2, 200, 2), (3, 3, 45, 3), (20, 6, 256, 6),
    (66, 6, 128, 2),     # 132 blocks: 2 of 6 heads' splits reach 264
    (1, 48, 64, 48),     # granite-34b's one kv head
])
def test_flash_bwd_splits_are_the_least_divisor_that_fills_the_card(bhkv, group, t, want):
    from repro_torch.kernels.flash_attention.kernel import (BWD_FILL_BLOCKS, BWD_KV_ROWS,
                                                            bwd_scratch_floats, bwd_splits)
    splits = bwd_splits(bhkv, group, t)
    assert splits == want and group % splits == 0
    blocks = bhkv * -(-t // BWD_KV_ROWS)
    assert splits == group or blocks * splits >= BWD_FILL_BLOCKS
    bhq, d = bhkv * group, 64
    base = -(-bhq * t // 4) * 4
    assert bwd_scratch_floats(bhq, bhkv, group, t, t, d) == (
        base + 2 * splits * bhkv * t * d if splits > 1 else base)


def test_flash_bwd_source_owns_the_wrapper_rows_a_block():
    """The wrapper's split rule counts the .cu's dK/dV blocks: 4 warps of 16
    kv rows, 64 a block, and the scratch holds the partials after Dv padded
    to 16 bytes."""
    from repro_torch.kernels.flash_attention.kernel import BWD_KV_ROWS
    text = build.SOURCES["flash_attention_bwd"].read_text()
    assert "constexpr int kWarps = 4;" in text and "constexpr int kA = 16 * kWarps;" in text
    assert BWD_KV_ROWS == 16 * 4
    assert "scratch + ((rows + 3) & ~int64_t(3))" in text


def test_compare_scripts_call_each_source_by_its_interface(tmp_path):
    """This tree's backward sources take the new arguments (flash's
    ``splits``, sLSTM's ``counters``); a source without them is called as
    the design before."""
    from repro_torch.kernels.flash_attention import compare as flash_compare
    from repro_torch.kernels.slstm import compare as slstm_compare
    assert flash_compare.takes_splits(flash_compare.BWD_SOURCE)
    assert slstm_compare.takes_counters(slstm_compare.SOURCE)
    old = tmp_path / "old.cu"
    old.write_text("int flash_attention_bwd_launch(float scale, void* stream);\n"
                   "int slstm_bwd_launch(void* dn0, int64_t S, void* stream);\n")
    assert not flash_compare.takes_splits(old) and not slstm_compare.takes_counters(old)


@pytest.mark.parametrize("module,argv", [
    ("repro_torch.kernels.flash_attention.compare", ["compare", "--backward"]),
    ("repro_torch.kernels.slstm.compare", ["compare"]),
    ("repro_torch.kernels.slstm.step_split", ["step_split", "--backward"]),
    ("repro_torch.kernels.rmsnorm.compare", ["compare"]),
])
def test_backward_timing_scripts_refuse_without_a_card(monkeypatch, module, argv):
    import importlib
    script = importlib.import_module(module)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", argv)
    with pytest.raises(SystemExit, match="no CUDA device"):
        script.main()


def test_variant_library_names_hash_the_headers_beside_the_source(tmp_path):
    """A header beside a source (``flash_mma.cuh``, which both flash
    sources include) is part of its libraries' names: editing it rebuilds
    them."""
    src, header = tmp_path / "k.cu", tmp_path / "h.cuh"
    src.write_text('#include "h.cuh"\n')
    header.write_text("// one\n")
    first = build.variant_path(src)
    header.write_text("// two\n")
    assert build.variant_path(src) != first
    assert (build.SOURCES["flash_attention"].parent / "flash_mma.cuh").is_file()
    assert not any(p.suffix == ".cuh" for p in build.SOURCES.values())


@pytest.mark.parametrize("rows,d,want", [
    (1024, 896, 128),     # qwen2-0.5b's gather round: one row a warp, one block an SM
    (1024, 2048, 128),    # xlstm-1.3b's d_model: two warps a row, two rows a slot
    (1024, 4096, 256),    # its mLSTM out-norm: four warps a row, two blocks an SM
    (16384, 2048, 256),   # the long shape: 64-row bands
    (128, 896, 16),       # the cut-depth card-vs-CPU round
    (7, 8192, 7),         # the card tests' 7 rows: one row a block, 8 warps a row
    (1, 896, 1), (1, 8192, 1),
])
def test_rmsnorm_bwd_blocks_are_a_function_of_the_shape(rows, d, want):
    """``bwd_blocks`` fixes the backward's grid, and with it the order of
    every dscale sum, from (rows, D) alone: within 1..BWD_MAX_BLOCKS (the
    .cu's cooperative grid, two blocks an SM), no block without a row, at
    most one row a slot's worth of blocks, two an SM only where every slot
    walks two rows or more."""
    from repro_torch.kernels.rmsnorm.kernel import (BWD_MAX_BLOCKS, BWD_WARPS, bwd_blocks,
                                                    bwd_warps_a_row)
    blocks = bwd_blocks(rows, d)
    assert blocks == want == bwd_blocks(rows, d)
    assert 1 <= blocks <= BWD_MAX_BLOCKS
    slots = BWD_WARPS // bwd_warps_a_row(d)
    band = -(-rows // blocks)
    assert (blocks - 1) * band < rows <= blocks * band
    assert blocks <= -(-rows // slots)
    if blocks > BWD_MAX_BLOCKS // 2:
        assert band >= 2 * slots


@pytest.mark.parametrize("d,want", [(1, 1), (896, 1), (1024, 1), (1025, 2), (2048, 2),
                                    (3000, 4), (4096, 4), (4097, 8), (8192, 8)])
def test_rmsnorm_bwd_warps_a_row_hold_at_most_1024_columns_a_warp(d, want):
    from repro_torch.kernels.rmsnorm.kernel import BWD_WARP_COLS, bwd_warps_a_row
    assert bwd_warps_a_row(d) == want
    assert want * BWD_WARP_COLS >= d and (want == 1 or want * BWD_WARP_COLS // 2 < d)


def test_rmsnorm_bwd_source_owns_the_wrapper_grid():
    """The wrapper's grid rule and barrier words are the .cu's: blocks of 8
    warps of at most 1024 columns, two blocks an SM (launch bounds), a
    cooperative launch, at most 512 blocks, three barrier words; one
    ``__global__`` function, named with the ``rmsnorm_bwd_`` prefix the
    train trace attributes device time by."""
    from repro_torch.kernels.rmsnorm.kernel import (BWD_ARGTYPES, BWD_BARRIER_WORDS,
                                                    BWD_MAX_BLOCKS, BWD_WARP_COLS, BWD_WARPS)
    text = build.SOURCES["rmsnorm_bwd"].read_text()
    assert f"constexpr int kWarps = {BWD_WARPS};" in text
    assert f"constexpr int kWarpCols = {BWD_WARP_COLS};" in text
    cap = int(re.search(r"constexpr int kMaxBlocks = (\d+);", text).group(1))
    assert BWD_MAX_BLOCKS <= cap
    assert "__launch_bounds__(kThreads, 2)" in text and "cudaLaunchCooperativeKernel" in text
    assert "words + 2" in text and BWD_BARRIER_WORDS == 3
    kernels = re.findall(r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(",
                         text)
    assert kernels == ["rmsnorm_bwd_kernel"]
    assert "atomicAdd(words" in text and text.count("atomicAdd") == 1
    assert len(BWD_ARGTYPES) == 13


def test_rmsnorm_compare_calls_each_source_by_its_interface(tmp_path):
    """This tree's rmsnorm_bwd takes ``blocks`` and the barrier words; a
    source taking ``chunks`` is called as the three-launch design, with its
    wrapper's chunks and scratch."""
    from repro_torch.kernels.rmsnorm import compare
    assert compare.takes_blocks(compare.SOURCE)
    old = tmp_path / "rmsnorm_bwd.cu"
    old.write_text("int rmsnorm_bwd_launch(const void* x, void* scratch, int64_t rows,\n"
                   "                       int64_t d, int64_t chunks, float eps, void* stream);\n")
    assert not compare.takes_blocks(old)
    assert [compare.chunks(r) for r in (1, 64, 65, 1024, 8192, 16384)] == [1, 1, 2, 16, 128, 128]
    assert len(compare.CHUNKS_ARGTYPES) == 12
    assert [c[1:] for c in compare.CASES] == [(1024, 896), (1024, 2048), (1024, 4096),
                                              (16384, 2048)]
