"""The port's stream_pack against the JAX package's, on the CPU.

The port's plain version (what ``stream_pack`` runs on CPU tensors) is held
against the Pallas kernel in interpret mode, mirroring
``test_kernels.py``; the CUDA kernel itself is checked on the card by
``chip_smoke.py``.  Tolerances as in ``test_kernels.py``: float32 1e-5
(summation order; 1e-4 in the property test), bfloat16 2e-2 (bf16 rounding
of the output).
"""

import os
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402

from repro.kernels.stream_pack import stream_pack_matmul as jax_stream_pack  # noqa: E402
from repro.kernels.stream_pack import stream_pack_matmul_ref as jax_ref  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.stream_pack import (  # noqa: E402
    kernel,
    packed_branches,
    stream_pack,
    stream_pack_matmul,
    stream_pack_matmul_ref,
)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pair(seed, shape, dtype):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return jnp.asarray(a, dtype=dtype), torch.from_numpy(a).to(getattr(torch, dtype))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("lanes", [1, 2, 7])
@pytest.mark.parametrize("mkn", [(16, 16, 16), (64, 32, 16), (128, 128, 128), (256, 64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shapes_dtypes(lanes, mkn, dtype):
    M, K, N = mkn
    jx, tx = _pair(0, (lanes, M, K), dtype)
    jw, tw = _pair(1, (lanes, K, N), dtype)
    got = stream_pack(tx, tw)
    assert got.dtype == tx.dtype and got.shape == (lanes, M, N)
    _close(got, jax_stream_pack(jx, jw, interpret=True), TOL[dtype])
    _close(got, jax_ref(jx, jw), TOL[dtype])


@pytest.mark.parametrize("blocks", [(16, 16, 16), (32, 64, 16), (64, 32, 32)])
def test_block_sweep(blocks):
    """The port accepts every block the TPU kernel accepts, and its plain
    version agrees with the TPU kernel run at those blocks."""
    bm, bn, bk = blocks
    jx, tx = _pair(2, (3, 64, 64), "float32")
    jw, tw = _pair(3, (3, 64, 64), "float32")
    assert kernel.check_blocks(64, 64, 64, bm, bn, bk) == (bm, bn, bk)
    want = jax_stream_pack(jx, jw, block_m=bm, block_n=bn, block_k=bk, interpret=True)
    _close(stream_pack(tx, tw), want, TOL["float32"])


def test_rejects_misaligned():
    """96 rows do not divide a 64-row block: the TPU kernel's ValueError,
    raised before any device is touched."""
    _, tx = _pair(4, (2, 96, 64), "float32")
    _, tw = _pair(5, (2, 64, 64), "float32")
    with pytest.raises(ValueError, match="must divide blocks"):
        stream_pack_matmul(tx, tw, block_m=64)
    jx, jw = jnp.asarray(tx.numpy()), jnp.asarray(tw.numpy())
    with pytest.raises(ValueError):
        jax_stream_pack(jx, jw, block_m=64, interpret=True)


def test_packed_branches_list_api():
    xs = [_pair(10 + i, (32, 16), "float32")[1] for i in range(5)]
    ws = [_pair(20 + i, (16, 8), "float32")[1] for i in range(5)]
    outs = packed_branches(xs, ws)
    assert len(outs) == 5
    for x, w, o in zip(xs, ws, outs):
        _close(o, (x @ w).numpy(), TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_lhs_form(dtype):
    """One x for every lane (2-d, or a stride-0 lane broadcast) gives each
    lane's x @ w; the list API passes a repeated x once."""
    _, x = _pair(6, (8, 64), dtype)
    _, w = _pair(7, (7, 64, 48), dtype)
    want = [(x.float() @ w[i].float()).to(x.dtype) for i in range(7)]
    for got in (stream_pack(x, w), stream_pack(x.expand(7, 8, 64), w),
                stream_pack_matmul_ref(x, w), torch.stack(packed_branches([x] * 7, list(w)))):
        assert got.shape == (7, 8, 48) and got.dtype == x.dtype
        for i in range(7):
            _close(got[i], want[i].float().numpy(), TOL[dtype])


@given(
    lanes=st.integers(1, 4),
    m=st.sampled_from([16, 32, 64]),
    k=st.sampled_from([16, 32]),
    n=st.sampled_from([16, 32]),
)
@settings(max_examples=25, deadline=None)
def test_property(lanes, m, k, n):
    jx, tx = _pair(lanes * m, (lanes, m, k), "float32")
    jw, tw = _pair(k * n, (lanes, k, n), "float32")
    _close(stream_pack(tx, tw), jax_stream_pack(jx, jw, interpret=True), 1e-4)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and never counts
    a launch; the kernel's own wrapper refuses CPU tensors."""
    _, x = _pair(8, (2, 16, 16), "float32")
    before = kernel.launches
    stream_pack(x, x)
    packed_branches(list(x), list(x))
    assert kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        stream_pack_matmul(x, x)


@pytest.mark.parametrize("bad, match", [
    (lambda x, w: (x[0], w), "3-d"),
    (lambda x, w: (x, w[:, :8]), "does not match"),
    (lambda x, w: (x.to("meta"), w.to("meta")), "CUDA"),
])
def test_kernel_wrapper_checks(bad, match):
    _, x = _pair(9, (2, 16, 16), "float32")
    with pytest.raises(ValueError, match=match):
        stream_pack_matmul(*bad(x, x))


def test_build_command_targets_hopper():
    out = build.library_path(kernel.SOURCE)
    argv = build.nvcc_argv("nvcc", kernel.SOURCE, out)
    assert "arch=compute_90a,code=sm_90a" in argv and str(kernel.SOURCE) in argv
    assert out.parent == build.BUILD_DIR and out.name.startswith("libstream_pack_")
    src = kernel.SOURCE.read_text()
    # a hand-written kernel: no library GEMM behind it
    assert "cublas" not in src.lower() and "extern \"C\" int stream_pack_matmul(" in src


# --- the launch chooser (plain Python: no card is needed to check it) -------

MAX_SMEM = 232448       # bytes of shared memory an H100 block may opt into
STATIC_SMEM = 49152     # bytes a block may use without opting in


def _chip_smoke():
    """The repo's chip_smoke.py as a module (its top level imports only the
    standard library)."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _chip_smoke()
# chip_smoke.py phase 6's (M, K, N) sweep and the four branchy cells' packed
# mm groups (lanes, M, K, N)
SWEEP = SMOKE.PACK_SHAPES
CELLS = list(SMOKE.BRANCHY_PACKS.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lmkn", [(lanes, *mkn) for lanes in (1, 12) for mkn in SWEEP] + CELLS)
def test_every_shape_gets_a_launch_the_card_takes(lmkn, dtype):
    """Each shape of the sweep and of the cells, in every layout of x and
    w, gets a kernel the library has, shared memory the card gives (above
    48 KB only where the tile needs it: stream_pack_init opts every kernel
    in), a grid within the launch limits and a tile that covers the
    product; cp.async copies only for row-major operands."""
    lanes, M, K, N = lmkn
    for aligned in (True, False):
        for layout in kernel.LAYOUTS:
            ln = kernel.choose_launch(lanes, M, N, K, dtype, aligned, x_t=layout[0] == "t",
                                      w_t=layout[1] == "t")
            assert ln.instance in kernel.INSTANCES and ln.layout == layout
            assert ln.variant.startswith("f32" if dtype == "float32" else "bf16")
            if ln.variant.startswith("f32"):
                assert ln.kc >= K if ln.stages == 1 else ln.kc == kernel.RING_KC
            else:
                assert ln.kc == kernel.RING_KC and ln.stages == kernel.RING_STAGES
            assert 0 < ln.smem_bytes <= MAX_SMEM
            if ln.variant.startswith("f32_panel"):
                assert ln.smem_bytes <= kernel.PANEL_MAX_SMEM
            gx, gy, gz = ln.grid
            assert gx <= kernel.MAX_GRID_X and gy <= kernel.MAX_GRID_YZ and gz == lanes
            assert gx * ln.bn >= N > (gx - 1) * ln.bn and gy * ln.bm >= M > (gy - 1) * ln.bm
            per_vec = 4 if dtype == "float32" else 8
            assert ln.vec == (aligned and layout == "nn" and K % per_vec == 0
                              and N % per_vec == 0)


def _phase6_launches():
    return [kernel.choose_launch(lanes, M, N, K, dname, offset == 0, x_t=layout[0] == "t",
                                 w_t=layout[1] == "t", shared=shared and lanes > 1)
            for dname, lanes, (M, K, N), shared, offset, layout in SMOKE.pack_cases()]


def test_phase6_launches_every_kernel():
    """chip_smoke.py phase 6's cases reach every kernel of the library (each
    loader of each ring tile, each layout, row tile and column tile of the
    stream) and every layout of x and w through each ring's element-wise
    loads, so each is held against the plain version on the card."""
    launches = _phase6_launches()
    assert {ln.instance for ln in launches} == set(kernel.INSTANCES)
    assert len(kernel.INSTANCES) == len(set(kernel.INSTANCES)) == 18 + 7 + 3
    assert {ln.instance for ln in launches if ln.variant.startswith("bf16_wgmma")} == {
        (f"bf16_wgmma/{lay}", 128, 256) for lay in ("nn", "nt", "tn")}
    assert SMOKE.pack_coverage(launches) == set()
    assert {ln.layout for ln in launches if ln.variant.endswith("/elem")} == set(kernel.LAYOUTS)


def test_library_opts_into_dynamic_shared_memory():
    """Tiles of every kind need more than the 48 KB a block gets without
    stream_pack_init's opt-in, and phase 6 launches some of each, so the
    card checks the opt-in; none asks for more than the card has."""
    launches = _phase6_launches()
    big = {ln.variant.split("/")[0] for ln in launches if ln.smem_bytes > STATIC_SMEM}
    assert big == {"f32_panel", "f32_ring", "bf16_ring", "bf16_tma", "bf16_wgmma"}
    assert max(ln.smem_bytes for ln in launches) <= MAX_SMEM


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lanes, K, N", [(lanes, K, N) for lanes, _, K, N in CELLS]
                         + [(3, 13, 7)])
def test_m8_takes_a_short_tile(lanes, K, N, dtype):
    """M = 8 (the branchy cells' batch) gets a tile of at most 16 rows, not
    the 64 of a fixed tile; the float32 cells take the panel in one load."""
    ln = kernel.choose_launch(lanes, 8, N, K, dtype, True)
    assert ln.bm <= 16
    if dtype == "float32" and K % 4 == 0:
        assert ln.variant == "f32_panel/vec" and ln.stages == 1 and ln.bm == 8
        assert ln.grid[0] * ln.grid[2] >= 18    # tens of blocks, not one per lane


@pytest.mark.parametrize("dtype, elem_bytes", [("float32", 4), ("bfloat16", 2)])
def test_unaligned_operands_take_the_elementwise_loads(dtype, elem_bytes):
    """K or N off the 16-byte vector, or a base pointer off 16 bytes, takes
    the masked element-wise variant; the same shape aligned takes cp.async."""
    per_vec = 16 // elem_bytes
    assert kernel.choose_launch(2, 8, 64, 64, dtype, True).vec
    assert not kernel.choose_launch(2, 8, 64, 64 + 1, dtype, True).vec        # K
    assert not kernel.choose_launch(2, 8, 64 + per_vec // 2, 64, dtype, True).vec  # N
    assert not kernel.choose_launch(2, 8, 64, 64, dtype, False).vec           # base
    buf = torch.zeros(1 + 2 * 8 * 64, dtype=getattr(torch, dtype))
    w = torch.zeros((2, 64, 64), dtype=buf.dtype)
    x_on, x_off = buf[: 2 * 8 * 64].view(2, 8, 64), buf[1:].view(2, 8, 64)
    assert kernel.vector_aligned(x_on, w) and not kernel.vector_aligned(x_off, w)
    assert kernel.launch_for(x_on, w).variant.endswith("/vec")
    assert kernel.launch_for(x_off, w).variant.endswith("/elem")
    shared = buf[1: 1 + 8 * 64].view(8, 64).expand(2, 8, 64)     # lane stride 0
    assert kernel.launch_for(shared, w).variant.endswith("/elem")


@pytest.mark.parametrize("M, bm", [(8, 8), (16, 16), (64, 32)])
def test_deep_k_streams(M, bm):
    """A float32 K panel over the panel's budget takes the 4-stage ring, its
    rows fitted to M as the panel's are."""
    ring = kernel.choose_launch(2, M, 64, 1024, "float32", True)
    assert ring.variant == "f32_ring/vec" and ring.stages == 4 and ring.kc == 64
    assert ring.bm == bm and ring.bn == kernel.F32_BN


@pytest.mark.parametrize("lanes, M, bm", [(12, 32, 32), (64, 64, 64), (3, 8, 16)])
def test_bf16_streams_on_32_columns(lanes, M, bm):
    """bf16 always streams through the ring, on 32 columns and rows fitted to
    M; at (12, 32, 256, 256) that is 96 blocks."""
    bf = kernel.choose_launch(lanes, M, 256, 256, "bfloat16", True)
    assert bf.variant == "bf16_ring/vec" and bf.stages == 4 and bf.kc == 64
    assert bf.bm == bm and bf.bn == 32 and bf.grid == (8, -(-M // bm), lanes)


@pytest.mark.parametrize("shape", [(70000, 8, 64, 64), (2, 65535 * 32 + 1, 64, 64)])
def test_grid_limits_raise_value_error(shape):
    lanes, M, K, N = shape
    with pytest.raises(ValueError, match="exceeds the launch grid"):
        kernel.choose_launch(lanes, M, N, K, "float32", True)


def test_chooser_refuses_other_dtypes():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kernel.choose_launch(1, 8, 8, 8, "float16", True)


# chip_smoke.py phase 6's MoE expert GEMMs: (lanes, d_model, d_ff_expert)
EXPERTS = SMOKE.EXPERT_GEMMS


def _covers(ln, lanes, M, N):
    """The stream's one launch covers the (lanes, M, N) output: its row
    and column tiles span M and N, and its persistent blocks (no more than
    the items, no more than the SMs) walk every item."""
    rows, cols = -(-M // ln.bm), -(-N // ln.bn)
    assert (rows - 1) * ln.bm < M <= rows * ln.bm and (cols - 1) * ln.bn < N <= cols * ln.bn
    assert ln.grid == (min(lanes * rows * cols, kernel.SMS), 1, 1)


@pytest.mark.parametrize("product", ["forward", "dx", "dw"])
@pytest.mark.parametrize("down", [False, True], ids=["gate_up", "down"])
@pytest.mark.parametrize("arch", sorted(EXPERTS))
def test_expert_gemms_get_a_launch_the_card_takes(arch, down, product):
    """The MoE expert GEMMs at every capacity serving gives them (4 decode
    slots, prefill buckets 64..512: M 2..64) at full width, bf16, 128 or
    160 lanes, take the TMA weight stream in each product: the forward x ·
    w (both row-major), dx = dy · wᵀ (w read transposed where it lies) and
    dw = xᵀ · dy (x read transposed).  Rows fitted to M (64 for xᵀ), a
    ring within the card's shared memory, one launch whose persistent
    blocks cover the product.  The lanes and widths are the configs';
    phase 6 checks B2 against its plain version at each of these M, and
    times it at 4 and 64; 19b checks and times the backward."""
    import repro_torch.configs as TC
    from repro_torch.models.moe import capacity

    cfg = TC.get(arch)
    lanes, D, F = EXPERTS[arch]
    assert (lanes, D, F) == (cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert)
    K, N = (F, D) if down else (D, F)
    served = sorted({capacity(n, cfg) for n in (4, 64, 128, 256, 512)})
    assert list(SMOKE.expert_capacities(arch)) == served
    assert set(SMOKE.EXPERT_TIMED_M) <= set(served)
    for M in served:
        # (rows, columns, depth) of the product and its layout
        rows, cols, depth, layout = {"forward": (M, N, K, "nn"), "dx": (M, K, N, "nt"),
                                     "dw": (K, N, M, "tn")}[product]
        ln = kernel.choose_launch(lanes, rows, cols, depth, "bfloat16", True,
                                  x_t=layout[0] == "t", w_t=layout[1] == "t")
        assert ln.variant == f"bf16_tma/{layout}" and ln.instance in kernel.INSTANCES
        want_rows = 64 if layout[0] == "t" else next(r for r in kernel.TMA_ROWS if M <= r)
        assert ln.bm == want_rows and ln.bn == kernel.TMA_BN and ln.kc == kernel.TMA_KC
        assert ln.stages == kernel.TMA_STAGES
        assert ln.smem_bytes == kernel.tma_smem_bytes(ln.bm, ln.stages) <= MAX_SMEM
        _covers(ln, lanes, rows, cols)


@pytest.mark.parametrize("why, args, kw, variant", [
    ("w's rows off 16 bytes", (160, 64, 1532, 5120), {}, "bf16_ring/elem"),
    ("x's rows off 16 bytes", (160, 64, 1536, 5116), {}, "bf16_ring/elem"),
    ("a base off 16 bytes", (160, 64, 1536, 5120, "bfloat16", False), {}, "bf16_ring/elem"),
    ("shared x", (160, 64, 1536, 5120), {"shared": True}, "bf16_ring/vec"),
    ("xᵀ's rows off 16 bytes", (160, 5116, 1536, 64), {"x_t": True}, "bf16_ring/elem"),
    ("both transposed", (160, 64, 1536, 5120), {"x_t": True, "w_t": True}, "bf16_ring/elem"),
    ("M past 64 over a small panel", (160, 65, 512, 256), {}, "bf16_ring/vec"),
    ("float32", (4, 64, 1536, 5120, "float32"), {}, "f32_ring/vec"),
    ("a small panel", (160, 64, 512, 256), {}, "bf16_ring/vec"),
    ("M 384, shared x", (160, 384, 1536, 5120), {"shared": True}, "bf16_ring/vec"),
    ("M 384, both transposed", (160, 384, 1536, 5120), {"x_t": True, "w_t": True},
     "bf16_ring/elem"),
    ("M 384, w's rows off 16 bytes", (160, 384, 1532, 5120), {}, "bf16_ring/elem"),
    ("M 384, a base off 16 bytes", (160, 384, 1536, 5120, "bfloat16", False), {},
     "bf16_ring/elem"),
    ("M 384 as dw's rows: xᵀ's rows off 16 bytes", (160, 383, 1536, 384), {"x_t": True},
     "bf16_ring/elem"),
    ("M 384 in dx: wᵀ's rows off 16 bytes", (160, 384, 1532, 5116), {"w_t": True},
     "bf16_ring/elem"),
])
def test_shapes_tma_cannot_take_go_to_the_rings(why, args, kw, variant):
    """Where neither the stream's nor the wgmma kernel's tensor maps can be
    built (a row or base off 16 bytes), x is shared (lane stride 0), both
    operands lie transposed, the type is float32 or the weight panel is
    under ``TMA_MIN_PANEL``, the product takes the named ring, at served
    capacities and at training's (M 384) alike."""
    lanes, M, N, K, *rest = args
    dtype, aligned = (rest + ["bfloat16", True][len(rest):])[:2]
    ln = kernel.choose_launch(lanes, M, N, K, dtype, aligned, **kw)
    assert ln.variant == variant, why
    assert ln.instance in kernel.INSTANCES and ln.grid[2] == lanes


def test_launch_for_reads_transposed_views_without_copying():
    """``launch_for`` and ``operands`` read the layout of a transposed view
    from its strides: the backward's wᵀ, xᵀ (also of a shared x) and a
    transposed dy are read where they lie, no copy, ``layout_copies``
    unchanged; a strided slice is copied once and counted."""
    lanes, M, K, N = 4, 16, 1024, 1024
    x = torch.zeros(lanes, M, K, dtype=torch.bfloat16)
    w = torch.zeros(lanes, K, N, dtype=torch.bfloat16)
    dy = torch.zeros(lanes, M, N, dtype=torch.bfloat16)
    before = kernel.layout_copies
    for a, b, layout in ((x, w, "nn"), (dy, w.transpose(1, 2), "nt"),
                         (x.transpose(1, 2), dy, "tn"),
                         (dy.transpose(1, 2).contiguous().transpose(1, 2), w.transpose(1, 2), "tt"),
                         (x[0].t().expand(lanes, K, M), dy, "tn")):
        got_a, got_b = kernel.operands(a, b)
        assert got_a is a and got_b is b
        assert kernel.launch_for(a, b).layout == layout
    assert kernel.launch_for(dy, w.transpose(1, 2)).variant == "bf16_tma/nt"
    assert kernel.launch_for(x.transpose(1, 2), dy).variant == "bf16_tma/tn"
    assert kernel.launch_for(x[0].t().expand(lanes, K, M), dy).variant == "bf16_ring/elem"
    assert kernel.layout_copies == before
    sliced = x[:, :, ::2]
    with pytest.raises(ValueError, match="row-major or transposed"):
        kernel.launch_for(sliced, w[:, ::2])
    got_x, got_w = kernel.operands(sliced, w[:, ::2])
    assert got_x.is_contiguous() and got_w.is_contiguous()
    assert kernel.layout_copies == before + 2
    kernel.layout_copies = before


# --- training's capacities: the wgmma kernel (bf16_wgmma) -------------------

# (rows, columns, depth, layout) of each product of one expert GEMM at
# capacity M with d_in K and d_out N: the forward x · w, dx = dy · wᵀ and
# dw = xᵀ · dy
PRODUCTS = {"forward": lambda M, K, N: (M, N, K, "nn"), "dx": lambda M, K, N: (M, K, N, "nt"),
            "dw": lambda M, K, N: (K, N, M, "tn")}


def test_deepseek_training_capacity_is_384():
    """A train_4k step of 2 x 4096 tokens gives each of deepseek-v2's 160
    experts round(8192 · 6 / 160 · 1.25) = 384 slots: the M of 19h's nine
    B2 products, and phase 6's ``TRAIN_EXPERT_M``."""
    import repro_torch.configs as TC
    from repro_torch.models.moe import capacity

    assert capacity(2 * 4096, TC.get("deepseek-v2-236b")) == 384 == SMOKE.TRAIN_EXPERT_M


@pytest.mark.parametrize("product", sorted(PRODUCTS))
@pytest.mark.parametrize("down", [False, True], ids=["gate_up", "down"])
def test_training_products_take_the_wgmma_kernel(down, product):
    """At the training capacity each of the three products of gate/up and
    down takes the wgmma kernel of its layout: 128 x 256 tiles 64 deep, a
    ring of ``WGMMA_STAGES``, the shared memory of the formula (and the
    card's), one persistent block an SM, whose items cover the output."""
    lanes, D, F = EXPERTS["deepseek-v2-236b"]
    K, N = (F, D) if down else (D, F)
    rows, cols, depth, layout = PRODUCTS[product](384, K, N)
    ln = kernel.choose_launch(lanes, rows, cols, depth, "bfloat16", True, x_t=layout[0] == "t",
                              w_t=layout[1] == "t")
    assert ln.variant == f"bf16_wgmma/{layout}" and ln.instance in kernel.INSTANCES
    assert (ln.bm, ln.bn, ln.kc, ln.stages) == (128, 256, 64, kernel.WGMMA_STAGES)
    assert ln.smem_bytes == kernel.wgmma_smem_bytes(ln.stages) <= MAX_SMEM
    assert ln.smem_bytes == 1024 + ln.stages * (128 + 256) * 128 + 128 * 256 + 16 * ln.stages
    _covers_in_clusters(ln, lanes, rows, cols)


def _covers_in_clusters(ln, lanes, rows, cols):
    """The wgmma kernel's one launch covers the (lanes, M, N) output: its
    clusters divide the row tiles, each cluster item is a column tile of
    ``cluster`` row tiles, and the blocks (at most the SMs, in whole
    clusters, no more than the items) walk every item."""
    row_tiles, col_tiles = -(-rows // ln.bm), -(-cols // ln.bn)
    assert (row_tiles - 1) * ln.bm < rows <= row_tiles * ln.bm
    assert (col_tiles - 1) * ln.bn < cols <= col_tiles * ln.bn
    assert row_tiles % ln.cluster == 0 and ln.cluster in kernel.WGMMA_CLUSTERS
    assert ln.cluster == next(c for c in (2, 3, 1) if row_tiles % c == 0)
    items = lanes * row_tiles // ln.cluster * col_tiles
    assert ln.grid == (min(items, kernel.SMS // ln.cluster) * ln.cluster, 1, 1)
    assert ln.grid[0] % ln.cluster == 0 and ln.grid[0] <= kernel.SMS


def test_wgmma_ring_fills_the_card():
    """The ring's depth is the most 48 KB stages the card holds beside the
    64 KB staged output tile."""
    assert kernel.wgmma_smem_bytes(kernel.WGMMA_STAGES) <= MAX_SMEM
    assert kernel.wgmma_smem_bytes(kernel.WGMMA_STAGES + 1) > MAX_SMEM


def _served_launch(lanes, rows, cols, layout):
    """The launch the served capacities took before the wgmma kernel: the
    TMA weight stream, rows fitted to M (64 where x lies transposed), a
    ring of 2 stages, one persistent block an SM."""
    rt = 64 if layout[0] == "t" else next(r for r in (16, 32, 64) if rows <= r)
    items = lanes * -(-rows // rt) * -(-cols // 256)
    smem = 1024 + 2 * (rt + 256) * 128 + 4 * 16 * 72 * 2 + 16 * 2
    return kernel.Launch(f"bf16_tma/{layout}", rt, 256, 64, 2, (min(items, 132), 1, 1), smem,
                         layout)


@pytest.mark.parametrize("product", sorted(PRODUCTS))
@pytest.mark.parametrize("arch", sorted(EXPERTS))
def test_served_capacities_keep_their_launch(arch, product):
    """At every capacity serving gives the experts (M 2-64), each product
    gets exactly the launch it got before the wgmma kernel (variant, tile,
    stages, grid, shared memory, layout)."""
    import repro_torch.configs as TC
    from repro_torch.models.moe import capacity

    cfg = TC.get(arch)
    lanes, D, F = EXPERTS[arch]
    for K, N in ((D, F), (F, D)):
        for M in sorted({capacity(n, cfg) for n in (4, 64, 128, 256, 512)}):
            assert M <= 64
            rows, cols, depth, layout = PRODUCTS[product](M, K, N)
            got = kernel.choose_launch(lanes, rows, cols, depth, "bfloat16", True,
                                       x_t=layout[0] == "t", w_t=layout[1] == "t")
            assert got == _served_launch(lanes, rows, cols, layout)


@pytest.mark.parametrize("M", [64, 65, 96, 127, 128, 200, 383, 384])
def test_wgmma_takes_m_past_64_and_dw_from_its_depth(M):
    """nn and nt take the wgmma kernel from M 65 (any M: its ragged rows
    are zero-filled and not stored), the stream up to 64; tn (dw) takes it
    from a depth of ``WGMMA_MIN_DEPTH`` tokens, the stream below."""
    lanes, K, N = 160, 5120, 1536
    for layout in ("nn", "nt"):
        ln = kernel.choose_launch(lanes, M, N, K, "bfloat16", True, w_t=layout == "nt")
        assert ln.variant == (f"bf16_wgmma/{layout}" if M > 64 else f"bf16_tma/{layout}")
    ln = kernel.choose_launch(lanes, K, N, M, "bfloat16", True, x_t=True)
    assert ln.variant == ("bf16_wgmma/tn" if M >= kernel.WGMMA_MIN_DEPTH else "bf16_tma/tn")
    assert 64 < kernel.WGMMA_MIN_DEPTH <= 384


def test_launch_for_reads_training_views_without_copying():
    """19h's backward hands B2 wᵀ and xᵀ as views at M 384: both take the
    wgmma kernel where they lie, no copy; a shared x keeps the ring."""
    lanes, M, K, N = 3, 384, 1024, 512
    x = torch.zeros(lanes, M, K, dtype=torch.bfloat16)
    w = torch.zeros(lanes, K, N, dtype=torch.bfloat16)
    dy = torch.zeros(lanes, M, N, dtype=torch.bfloat16)
    before = kernel.layout_copies
    for a, b, layout in ((x, w, "nn"), (dy, w.transpose(1, 2), "nt"), (x.transpose(1, 2), dy, "tn")):
        got_a, got_b = kernel.operands(a, b)
        assert got_a is a and got_b is b
        assert kernel.launch_for(a, b).variant == f"bf16_wgmma/{layout}"
    assert kernel.launch_for(x[0].expand(lanes, M, K), w).variant == "bf16_ring/vec"
    assert kernel.layout_copies == before


def test_phase6_times_the_training_products():
    """Phase 6 holds and times deepseek-v2's six (product, layout) shapes at
    M 384 on 160 lanes, and its ragged wgmma cases end inside a tile in M
    (65, 200, 383), in N, in K and in dw's depth and rows."""
    lanes, D, F = EXPERTS["deepseek-v2-236b"]
    assert lanes == 160 and (D, F) == (5120, 1536)
    shapes = SMOKE.PACK_WGMMA_SHAPES
    assert {M for _, M, _, _, lay in shapes if lay != "tn"} == {65, 200, 383}
    assert {K for _, _, K, _, lay in shapes if lay == "tn"} >= {200, 383}
    assert any(N % 256 and N % 256 <= 64 for *_, N, _ in shapes)
    assert any(M % 128 and M % 128 <= 64 for _, M, _, _, lay in shapes if lay == "tn")
    assert any(K % 64 for _, _, K, _, lay in shapes if lay != "tn")
    assert SMOKE.TRAIN_REPEAT[0] in PRODUCTS
