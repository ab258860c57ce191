"""The kernel build's bookkeeping (dddpm_tpu_torch/ops/_build.py), on the
CPU: which library a source and its defines map to, and the ptxas report
read back from the log kept beside it.  Nothing is compiled here."""
import pytest

from dddpm_tpu_torch.ops import _build

LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z15winograd_kernelIfEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _Z15winograd_kernelIfEvPKT_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z14weights_kernelIfEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _Z14weights_kernelIfEvPKT_
    8 bytes stack frame, 20 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
"""


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    return tmp_path


def test_defines_name_their_own_library(build_dir):
    plain = _build._target("winograd")
    gated = _build._target("winograd", ("WINOGRAD_SKIP=1",))
    assert plain.parent == gated.parent == build_dir
    assert plain != gated != _build._target("winograd", ("WINOGRAD_SKIP=2",))
    assert plain == _build._target("winograd", ())
    assert plain.name.startswith("libwinograd_") and plain.suffix == ".so"


def test_ptxas_report_reads_the_kept_log(build_dir):
    target = _build._target("winograd")
    target.write_bytes(b"")
    target.with_suffix(".log").write_text(LOG)
    assert _build.build_log("winograd") == LOG
    assert _build.ptxas_report("winograd") == [
        {"kernel": "_Z15winograd_kernelIfEvPKT_", "spill_stores": 0,
         "spill_loads": 0, "registers": 128},
        {"kernel": "_Z14weights_kernelIfEvPKT_", "spill_stores": 20,
         "spill_loads": 12, "registers": 32}]


CALLEE_LOG = """\
ptxas info    : Compiling entry function '_Z6kernelv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 16 barriers
ptxas info    : Function properties for _Z5phasev
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Function properties for _Z5otherv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
"""


def test_ptxas_report_counts_a_called_functions_spills(build_dir):
    """A function that is not inlined gets its own properties line after
    its kernel's; its spill bytes count as the kernel's and leave the
    next kernel's alone."""
    target = _build._target("attention_block")
    target.write_bytes(b"")
    target.with_suffix(".log").write_text(CALLEE_LOG)
    assert _build.ptxas_report("attention_block") == [
        {"kernel": "_Z6kernelv", "spill_stores": 4, "spill_loads": 8,
         "registers": 128},
        {"kernel": "_Z5otherv", "spill_stores": 0, "spill_loads": 0,
         "registers": 64}]


def test_a_library_without_its_log_is_rebuilt(build_dir, monkeypatch):
    """build_log raises before a build; a library whose log is missing
    goes back to nvcc (here a stand-in that fails), one with its log is
    reused."""
    with pytest.raises(FileNotFoundError):
        _build.build_log("winograd")
    target = _build._target("winograd")
    target.write_bytes(b"")
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build._finish("winograd", _build._start("winograd"))
    target.with_suffix(".log").write_text(LOG)
    assert _build._start("winograd") is None


def test_a_header_edit_names_another_library(build_dir, tmp_path, monkeypatch):
    """A library's name hashes the headers of csrc/ too, so an edited
    header is rebuilt, not served stale from the cache."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in ("conv3x3.cu", "mma_sm90.cuh"):
        (csrc / f).write_bytes((_build.CSRC / f).read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    header = csrc / "mma_sm90.cuh"
    text, first = header.read_bytes(), _build._target("conv3x3")
    header.write_bytes(text + b"// edited\n")
    assert _build._target("conv3x3") != first
    header.write_bytes(text)
    assert _build._target("conv3x3") == first


@pytest.mark.parametrize("name", ["conv3x3", "winograd", "probe_cmajor_conv",
                                  "convres_fwd", "convres_bwd", "attention_block",
                                  "int8_conv", "convres_general", "linear_attention",
                                  "probe_attention", "probe_convres"])
def test_tensor_core_kernels_share_one_copy_of_the_fragment_helpers(name):
    """K5, K6, P4, K2, K3, K1a/K1b/K1c, Q1, K2/K3's width-general route,
    K4, P1a/P1b and P3 include csrc/mma_sm90.cuh and define none of its
    helpers themselves, so they cannot drift apart."""
    source = (_build.CSRC / f"{name}.cu").read_text()
    assert '#include "mma_sm90.cuh"' in source
    for helper in ("cp_async16(", "ldmatrix_x4(", "ldmatrix_x4_trans(",
                   "stmatrix_x4(", "stmatrix_x4_trans(", "mma_bf16("):
        assert f"void {helper}" not in source, helper


def test_int8_kernel_rounds_as_its_plain_version():
    """Q1 takes its s8 helpers from csrc/mma_s8_sm90.cuh, and every float
    step that decides its bits is a correctly rounded intrinsic (never
    contracted into an FMA): the quantize's division (or its reciprocal
    product where that provably rounds alike), the scale product, the
    dequantize multiply and the skip operand's add."""
    source = (_build.CSRC / "int8_conv.cu").read_text()
    header = (_build.CSRC / "mma_s8_sm90.cuh").read_text()
    assert '#include "mma_s8_sm90.cuh"' in source
    for helper in ("void wgmma_s8_n128(", "int quantize_s8(", "uint2 quantize8_s8(",
                   "unsigned pack_s8x4("):
        assert helper in header and helper not in source, helper
    assert "__fdiv_rn(v, xs)" in header and "__float2int_rn" in header
    # the 8-wide quantize: v * (1 / xs) correctly rounded decides, except
    # near a .5 tie, where the IEEE division does
    for op in ("__fmul_rn(v[j], inv)", "q[j] = quantize_s8(v[j], xs)"):
        assert op in header, op
    assert "__frcp_rn(xs0)" in source
    for op in ("__fdiv_rn(fmaxf(", "__fmul_rn(xs, ", "__fmul_rn(__int2float_rn(",
               "__fadd_rn(y[j * 4 + i], v[i])"):
        assert op in source, op
    assert "use_fast_math" not in " ".join(_build.NVCC_FLAGS)


@pytest.mark.parametrize("name", ["int8_conv"])
def test_wgmma_kernels_share_one_copy_of_the_hopper_helpers(name):
    """Q1 takes its mbarrier, bulk-copy, TMA, named-barrier, setmaxnreg
    and wgmma helpers from csrc/wgmma_sm90.cuh, defines none of them and
    holds no inline PTX of its own."""
    source = (_build.CSRC / f"{name}.cu").read_text()
    header = (_build.CSRC / "wgmma_sm90.cuh").read_text()
    assert '#include "wgmma_sm90.cuh"' in source
    for helper in ("void mbar_init(", "void mbar_fence_init(", "void mbar_arrive(",
                   "void mbar_arrive_expect_tx(", "void mbar_wait(", "void bulk_g2s(",
                   "void setmaxnreg_inc(", "void setmaxnreg_dec(", "void wgmma_fence(",
                   "void wgmma_commit(", "void wgmma_wait(", "void wgmma_fence_operand(",
                   "void compiler_barrier(", "uint64_t wgmma_desc(", "void tma_load_4d(",
                   "bool make_tensor_map_4d(", "void bar_sync("):
        assert helper in header and helper not in source, helper
    assert "asm" not in source


@pytest.mark.parametrize("name", ["conv3x3", "convres_fwd", "convres_general",
                                  "probe_convres"])
def test_mish_kernels_share_one_copy_of_the_fast_mish(name):
    """K5, K2, K2/K3's width-general route and P3 include csrc/mish_sm90.cuh
    (mish by one ex2 and one rcp) and define neither it nor its two
    instructions' helpers themselves."""
    source = (_build.CSRC / f"{name}.cu").read_text()
    assert '#include "mish_sm90.cuh"' in source
    for helper in ("mish(", "ex2_ftz(", "rcp_ftz("):
        assert f"float {helper}" not in source, helper
    for slow in ("expf(", "log1pf(", "tanhf("):
        assert slow not in source, slow


def _body(source: str, head: str) -> str:
    """The text of the function that starts at `head`, to its closing
    brace at the start of a line."""
    start = source.index(head)
    return source[start:source.index("\n}\n", start)]


def test_general_route_runs_bf16_on_the_tensor_cores():
    """csrc/convres_general.cu launches its FMA kernels (conv_gemm,
    conv_wgrad) for f32 only, from the overloads that take f32, and its
    tensor-core kernels (conv1x1_mma, conv3x3_mma, wgrad1x1_mma,
    wgrad3x3_mma) for bf16, from those that take bf16: their products
    are mma.sync on slabs a cp.async ring fills, the FMA kernels' fmaf
    loops."""
    source = (_build.CSRC / "convres_general.cu").read_text()
    for launch, takes in (("conv_gemm<float><<<", "ConvArgs<float>& a"),
                          ("conv1x1_mma<<<", "ConvArgs<bf16>& a"),
                          ("conv3x3_mma<<<", "ConvArgs<bf16>& a"),
                          ("conv_wgrad<float><<<", "const float* in"),
                          ("wgrad1x1_mma<<<", "const bf16* in"),
                          ("wgrad3x3_mma<<<", "const bf16* in")):
        assert source.count(launch) == 1, launch
        head = source[:source.index(launch)]
        assert takes in head[head.rindex("\ncudaError_t "):], launch
    for kernel in ("conv_gemm<bf16>", "conv_wgrad<bf16>", "conv_gemm<T><<<",
                   "conv_wgrad<T><<<"):
        assert kernel not in source, kernel
    for head, ring in (("conv1x1_mma(const ConvArgs<bf16> a) {", "STAGES"),
                       ("conv3x3_mma(const ConvArgs<bf16> a) {", "STAGES3"),
                       ("wgrad1x1_mma(const bf16* __restrict__ in", "STAGES"),
                       ("wgrad3x3_mma(const bf16* __restrict__ in", "STAGES3")):
        body = _body(source, head)
        for op in ("mma_bf16(", "ldmatrix_x4", "cp_async16(",
                   f"cp_async_wait<{ring} - 2>()"):
            assert op in body, (head, op)
        assert "fmaf(" not in body, head
    for head in ("conv_gemm(const ConvArgs<T> a) {",
                 "conv_wgrad(const T* __restrict__ in"):
        body = _body(source, head)
        assert "fmaf(" in body and "mma_bf16(" not in body, head


def test_one_pass_attention_runs_bf16_through_the_two_pass_items():
    """csrc/attention_block.cu's bf16 one-pass entry launches
    block_1p_mma_kernel cooperatively, and that kernel runs pass A's and
    pass B's work through the same item loops and item functions as
    ctx_mma_kernel and out_mma_kernel (one copy of each, holding the
    mma.sync products), with the reduce and the f32 fold between three
    grid barriers; f32 keeps the FMA kernel block_1p_kernel."""
    source = (_build.CSRC / "attention_block.cu").read_text()
    # each pass's loop over its items calls its item function, once
    for head, call, n in (("ctx_mma_items(const bf16* x", "ctx_mma_item<WIDE, CPL>(", 1),
                          ("out_mma_items(const bf16* x", "out_mma_item<WIDE, NT>(", 2)):
        assert _body(source, head).count(call) == n, head   # pass B: either order
    # the two-pass kernels and the one-pass kernel's passes run those loops
    for head, call in (("ctx_mma_kernel(const bf16* x", "ctx_mma_items<WIDE, CPL>("),
                       ("ctx_phase_1p(const bf16* x", "ctx_mma_items<WIDE, CPL>("),
                       ("out_mma_kernel(const bf16* x", "out_mma_items<WIDE, NT, false>("),
                       ("block_1p_mma_kernel(const bf16* x", "out_mma_items<WIDE, NT, true>(")):
        body = _body(source, head)
        assert call in body and "mma_k<" not in body, head
    one_pass = _body(source, "block_1p_mma_kernel(const bf16* x")
    for call in ("ctx_phase_1p<WIDE, CPL>(", "out_mma_items<WIDE, NT, true>(",
                 "reduce_phase_1p(", "fold_phase_1p("):
        assert one_pass.count(call) == 1, call
    assert "reduce_head(" in _body(source, "void reduce_phase_1p(")
    assert "fold_rows<bf16>(" in _body(source, "void fold_phase_1p(")
    assert one_pass.count("this_grid().sync()") == 3 and "mma_k<" not in one_pass
    for head in ("ctx_mma_item(const CtxSmem& s", "out_mma_item(const OutSmem& s"):
        body = _body(source, head)
        assert "mma_k<" in body and "fmaf(" not in body, head
    assert "block_1p_mma_kernel<" in _body(source, "int with_1p_kernel(")
    launch = _body(source, "int launch_1p_mma(")
    assert "cudaLaunchCooperativeKernel(" in launch and "with_1p_kernel(" in launch
    entry = _body(source, "int attn_1p(const void* x")
    assert "launch_1p_mma(" in entry and "launch_1p<float>(" in entry
    fma = _body(source, "block_1p_kernel(const T* x")
    assert "ctx_partial_item<T>(" in fma and "out_tile<T, -1>(" in fma
    assert "mma" not in fma


def test_linear_attention_runs_bf16_on_the_tensor_cores():
    """csrc/linear_attention.cu's bf16 entries launch lin_ctx_mma and
    lin_out_mma, whose products are mma.sync on rows a cp.async ring
    brings (the ctx kernel's p as a bf16 pair, hi and lo, both
    multiplied); f32 launches the FMA kernels lin_ctx_partial and
    lin_out."""
    source = (_build.CSRC / "linear_attention.cu").read_text()
    for head in ("lin_ctx_mma(const bf16* __restrict__ k",
                 "lin_out_mma(const bf16* __restrict__ q"):
        body = _body(source, head)
        for op in ("mma_bf16(", "ldmatrix_x4", "load_rows(", "cp_async_commit()"):
            assert op in body, (head, op)
        assert "fmaf(" not in body, head
    ctx = _body(source, "lin_ctx_mma(const bf16* __restrict__ k")
    for op in ("ldmatrix_x4_trans(ah[i]", "ldmatrix_x4_trans(al[i]",
               "__floats2bfloat162_rn(p.x - hf.x, p.y - hf.y)"):
        assert op in ctx, op
    for head in ("lin_ctx_partial(const T* __restrict__ k",
                 "lin_out(const T* __restrict__ q"):
        body = _body(source, head)
        assert "fmaf(" in body and "mma_bf16(" not in body, head
    entries = source[source.index('extern "C" {'):]
    for launch in ("ctx_launch_mma(", "out_launch_mma(", "ctx_launch<float>(",
                   "out_launch<float>("):
        assert entries.count(launch) == 1, launch
    assert "__nv_bfloat16>(" not in entries


def test_attention_probe_runs_on_the_tensor_cores():
    """csrc/probe_attention.cu (P1a, P1b): both passes' products are
    mma.sync (pass A's second, A += p^T v, reading p transposed), with
    no fmaf( anywhere; every variant of either pass, dma included, takes
    x through the one cp.async load function (load_sub, called before
    the variant's own work, twice a kernel: the ring's first sub-tile
    and each next one); the reduce sums the partials in tile order, with
    no atomics."""
    source = (_build.CSRC / "probe_attention.cu").read_text()
    assert "fmaf(" not in source and "atomicAdd" not in source
    load = _body(source, "void load_sub(bf16* dst")
    assert "cp_async16(" in load
    assert "mma_bf16(" in _body(source, "void mma_rows(float")
    # the dma variants' own work: pass A folds the landed words, pass B
    # stores them through store_sub, which every pass-B variant ends with
    for head, dma in (("probe_ctx_kernel(const bf16* x", "hx ^= v.x ^ v.y ^ v.z ^ v.w"),
                      ("probe_out_kernel(const bf16* x", "store_sub(")):
        body = _body(source, head)
        assert body.count("load_sub(") == 2 and body.count(dma) == 1, head
        assert "cp_async16(" not in body and "uint4*>(x" not in body, head
        second = body.index("load_sub(", body.index("load_sub(") + 1)
        assert second < body.index(dma) and second < body.index("mma_rows<"), head
    ctx = _body(source, "probe_ctx_kernel(const bf16* x")
    assert "ldmatrix_x4_trans(a[i]" in ctx and "mma_bf16(acc_a[" in ctx
    # the LN's row sums are products with ones too, in both passes
    assert "mma_bf16(s1, a, ONES, ONES)" in _body(source, "void frag_sums(const bf16* A")
    assert "ln_partials(cur" in ctx and "ln_apply(cur" in ctx
    assert "frag_sums<" in _body(source, "probe_out_kernel(const bf16* x")
    reduce = _body(source, "probe_ctx_reduce(const float* part_a")
    assert "for (int j = 0; j < nt; ++j)" in reduce
    assert "slot = (size_t)bi * nt + j" in reduce


def test_convres_probe_runs_on_the_tensor_cores():
    """csrc/probe_convres.cu (P3): every variant's products go through
    convres_sm90.cuh's gemm32 passes and its mma (mma.sync), with no
    fmaf( and no __shfl_sync product loop anywhere; the im2col stage is
    copied and read only inside `if constexpr (IM2COL)` (G2's and G3's),
    and only the IM2COL instantiations (base, rowmask, nomask, bf16mish,
    tile2x: variants 0-2, 4, 5) reach it."""
    source = (_build.CSRC / "probe_convres.cu").read_text()
    assert "fmaf(" not in source and "__shfl_sync" not in source
    kernel = _body(source, "probe_convres_kernel(const bf16* __restrict__ x")
    for op in ("gemm32<true, CIO / 16>(", "gemm32<false, 18>(",
               "gemm32_n<false, 18, 1>(acc, a_lane, w3s", "mma(o[0], a3[kc]"):
        assert op in kernel, op
    for src, w in (("m1s", "w2s"), ("m2s", "w3s")):
        at = kernel.index(f"im2col({src}, ")
        assert kernel.count(f"im2col({src}, ") == 1, src
        branch = kernel.rindex("if constexpr (", 0, at)
        assert kernel.startswith("if constexpr (IM2COL) {", branch), src
        other = kernel.index("} else {", at)
        assert "} else {" not in kernel[branch:at], src
        assert f"gemm32_n<false, 18, 1>(acc, stage_lane, {w}" in kernel[at:other], src
    assert kernel.count("stage_lane, w") == 2
    entry = source[source.index('extern "C" {'):]
    cases = [line.split("(")[1].split(",") for line in entry.splitlines()
             if "return DDDPM_PROBE_CONVRES(" in line]
    assert [c[1].strip() for c in cases] == ["true", "true", "true", "false", "true",
                                             "true", "false"]


def _block(source: str, head: str) -> str:
    """The braced block that opens at `head` (its last character a
    brace), found by counting braces."""
    start = source.index(head) + len(head)
    depth = 1
    for i in range(start, len(source)):
        depth += {"{": 1, "}": -1}.get(source[i], 0)
        if depth == 0:
            return source[start:i]
    raise ValueError(head)


def test_convres_backward_sums_weights_on_the_tensor_cores():
    """csrc/convres_bwd.cu's bf16 K3 (namespace tc) forms all four weight
    gradients and the four bias sums on the tensor cores: no fmaf( and no
    scalar outer-product helper (outer48) in the namespace; stage B's
    sums go through wsum / wcolsum, which read both operands by
    ldmatrix.trans and multiply with the shared mma_bf16 (dw3, dw2 in
    the tap loop; dw4 and dw1 a 32-channel piece a warp), and the whole
    of stage B sits under CONVRES_SKIP's bit 8, which the ablation probe
    relies on; the f32 kernel keeps its FMA loops."""
    source = (_build.CSRC / "convres_bwd.cu").read_text()
    tc = source[source.index("namespace tc {"):source.index("}  // namespace tc")]
    assert "fmaf(" not in tc and "outer48" not in tc
    for helper, ops in (("void wsum(float", ("ldmatrix_x4_trans(af[0]", "mma_bf16(")),
                        ("void wcolsum(float", ("mma_bf16(s[nt], ones",)),
                        ("void wload_b(unsigned", ("ldmatrix_x4_trans(bf[0]",))):
        body = _body(tc, helper)
        for op in ops:
            assert op in body, (helper, op)
    kernel = _body(tc, "convres_bwd_kernel(const bf16* __restrict__ x")
    stage_b = _block(kernel, "if (!(SKIP & 8)) {")
    assert kernel.count("SKIP & 8") == 1
    for call, n in (("wsum(a3, ", 1), ("wsum(a2, ", 1), ("wsum(acc, ", 2),
                    ("wcolsum(", 3), ("wload_b(", 6)):
        assert stage_b.count(call) == n, call
        assert kernel.count(call) == n, call      # nowhere outside stage B
    for out in ("L::DW4", "L::DW1", "L::DB4", "L::DB1", "L::DB3", "L::DB2"):
        assert out in stage_b, out
    assert "wstore<false>(pb + L::DW3" in kernel and "wstore<false>(pb + L::DW2" in kernel
    f32 = source[source.index("namespace f32 {"):source.index("}  // namespace f32")]
    assert "fmaf(" in f32 and "mma" not in f32


@pytest.mark.parametrize("name", ["convres_fwd", "convres_bwd", "probe_convres"])
def test_convres_kernels_share_one_copy_of_the_gemm_helpers(name):
    """K2, K3 and P3 include csrc/convres_sm90.cuh (the implicit-GEMM pass
    and the bf16-pair helpers) and define none of them themselves."""
    source = (_build.CSRC / f"{name}.cu").read_text()
    assert '#include "convres_sm90.cuh"' in source
    for helper in ("unsigned pack2(", "unsigned act2(", "void gemm32_nb(",
                   "void gemm32_n(", "void gemm32(", "void mma(",
                   "void mish_dmish("):
        assert helper not in source, helper


def test_build_all_starts_every_library_before_waiting(monkeypatch):
    """build_all starts every nvcc before it waits on the first, so the
    sources compile in parallel."""
    events = []
    monkeypatch.setattr(_build, "_start",
                        lambda n: events.append(("start", n)) or n)
    monkeypatch.setattr(_build, "_finish",
                        lambda n, st: events.append(("finish", n, st)))
    _build.build_all(["convres_fwd", "convres_bwd"])
    assert events == [("start", "convres_fwd"), ("start", "convres_bwd"),
                      ("finish", "convres_fwd", "convres_fwd"),
                      ("finish", "convres_bwd", "convres_bwd")]
