"""B8, the port's RMSNorm (``repro_torch.kernels.rms_norm``), on the CPU.

The kernels run only on the card (``chip_smoke.py`` phase 3e holds them
against their plain versions there); here the plain versions stand in for
them, through the same wrappers and the same autograd Function.  Inputs are
numpy-seeded at small widths: a warp's row (48), an odd width (7), a
block's row (1100) and a row of one.  Tolerances:

* the forward against JAX's ``apply_norm`` and ``_rms(x) * scale``: float32
  within 1e-6 (rtol and atol); bf16 within one bf16 ulp of JAX's value
  (both round one float32 value, computed in another order, to bf16);
* the backward (the closed form of :func:`ref.rms_norm_bwd_ref`, through
  :class:`ops.RMSNorm`) against ``jax.grad`` of the same JAX functions and
  against ``torch.autograd`` of the plain forward: float32 within rtol 1e-5
  and atol 1e-5 of the largest magnitude of dscale, or for dx of
  ``rstd * dy * (offset + scale)`` (dx is the difference of two terms of
  that size, so an element near 0 keeps no relative precision: a row of
  one has dx 0 up to that rounding).

Also: the plans (:func:`kernel.choose_launch`, :func:`kernel.choose_backward`)
at every shape the paths give B8 and at widths beyond the backward's
register plan, the wrappers' refusals, the rows read where they lie (MLA's c_kv in its
576-wide rows) and a copy counted otherwise, the library call over a fake
library (the tensors' own pointers and strides, the backward's plan and its
partial-row scratch, the vector flag, a failed
launch raises and never reaches the plain version, no rows launch
nothing), the routing (CPU and meta through ``run_plain``, a DTensor
refused by the wrapper and run on its local shards by the layer's
function, on gloo (1, 2) and (2, 1) meshes with no collective), the dry
run's count, and ``chip_smoke.py``'s 3e case list.
"""

import dataclasses
import importlib.util
import os
import types
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from _sharded_harness import run_mesh  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mla as JM  # noqa: E402
from repro_torch.kernels import plain_watchers  # noqa: E402
from repro_torch.kernels.rms_norm import backward, kernel, ops  # noqa: E402
from repro_torch.kernels.rms_norm.ref import rms_norm_bwd_ref, rms_norm_ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FWD_TOL = 1e-6
GRAD_RTOL = 1e-5
WIDTHS = [48, 7, 1100, 1]
EPS = 1e-6


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(width, seed=0, lead=(2, 5)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((*lead, width)) * 3.0).astype(np.float32)
    scale = (rng.standard_normal(width) * 0.5).astype(np.float32)
    dy = rng.standard_normal((*lead, width)).astype(np.float32)
    return x, scale, dy


def _cfg(eps=EPS):
    return types.SimpleNamespace(norm_eps=eps)


def _jax_norm(offset):
    """JAX's function for ``offset``: ``apply_norm``'s rmsnorm branch, or
    ``_rms(x) * scale`` rounded to x's dtype (the qk-norm's and MLA's)."""
    if offset == 1.0:
        return lambda x, s: JL.apply_norm({"scale": s}, x, _cfg())
    return lambda x, s: (JL._rms(x) * s).astype(x.dtype)


def _torch_norm(offset):
    """The port's layer function for ``offset``."""
    if offset == 1.0:
        return lambda x, s: TL.apply_norm({"scale": s}, x, _cfg())
    return TL._rms_scaled


def _grad_close(got, want, scale=None):
    """Within rtol GRAD_RTOL and GRAD_RTOL of ``scale``'s largest magnitude
    (the gradient's own by default)."""
    want = np.asarray(want, np.float32)
    scale = np.abs(want if scale is None else scale).max()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * max(float(scale), 1e-30))


def _dx_scale(x, scale, dy, offset):
    """``rstd * dy * (offset + scale)``: the first of the two terms dx is
    the difference of, both of the row's size."""
    rstd = 1.0 / np.sqrt((x.astype(np.float64) ** 2).mean(-1, keepdims=True) + EPS)
    return rstd * dy * (offset + scale)


def _bf16_ulp(v):
    a = np.maximum(np.abs(np.asarray(v, np.float32)), np.float32(2.0 ** -126))
    return np.ldexp(np.float32(1.0), np.frexp(a)[1] - 8)


# ---------------------------------------------------------------------------
# the plain versions against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offset", [1.0, 0.0], ids=["apply_norm", "rms_times_scale"])
@pytest.mark.parametrize("width", WIDTHS)
def test_forward_matches_jax_float32(width, offset):
    x, scale, _ = _inputs(width, seed=width)
    got = _torch_norm(offset)(torch.tensor(x), torch.tensor(scale))
    want = _jax_norm(offset)(jnp.asarray(x), jnp.asarray(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("offset", [1.0, 0.0], ids=["apply_norm", "rms_times_scale"])
@pytest.mark.parametrize("width", WIDTHS)
def test_forward_matches_jax_bf16_within_one_ulp(width, offset):
    x, scale, _ = _inputs(width, seed=width + 1)
    xb = torch.tensor(x).bfloat16()
    got = _torch_norm(offset)(xb, torch.tensor(scale))
    assert got.dtype == torch.bfloat16
    want = np.asarray(_jax_norm(offset)(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                                        jnp.asarray(scale)).astype(jnp.float32))
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= _bf16_ulp(want)).all(), diff.max()


@pytest.mark.parametrize("offset", [1.0, 0.0], ids=["apply_norm", "rms_times_scale"])
@pytest.mark.parametrize("width", WIDTHS)
def test_backward_matches_jax_grad(width, offset):
    """dx and dscale through ``ops.RMSNorm`` (the plain backward) against
    ``jax.grad`` of ``sum(f(x, scale) * dy)``."""
    x, scale, dy = _inputs(width, seed=width + 2)
    f = _jax_norm(offset)
    want_dx, want_ds = jax.grad(lambda a, b: jnp.sum(f(a, b) * dy), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(scale))
    tx = torch.tensor(x, requires_grad=True)
    ts = torch.tensor(scale, requires_grad=True)
    y = _torch_norm(offset)(tx, ts)
    y.backward(torch.tensor(dy))
    _grad_close(tx.grad, want_dx, _dx_scale(x, scale, dy, offset))
    _grad_close(ts.grad, want_ds)


@pytest.mark.parametrize("offset", [1.0, 0.0])
@pytest.mark.parametrize("width", WIDTHS)
def test_plain_backward_is_autograd_of_the_plain_forward(width, offset):
    x, scale, dy = _inputs(width, seed=width + 3)
    tx = torch.tensor(x, requires_grad=True)
    ts = torch.tensor(scale, requires_grad=True)
    y, rstd = rms_norm_ref(tx, ts, EPS, offset)
    y.backward(torch.tensor(dy))
    dx, ds = rms_norm_bwd_ref(tx.detach(), ts.detach(), rstd.detach(), torch.tensor(dy), offset)
    _grad_close(dx, tx.grad.numpy(), _dx_scale(x, scale, dy, offset))
    _grad_close(ds, ts.grad.numpy())


def test_the_qk_norm_of_attention_matches_jax():
    """``attention`` with ``qk_norm`` (phi4-mini's smoke config with the
    flag set): q and k through B8's plain version at offset 0, the output
    against JAX's (the flash tests' 2e-5)."""
    jcfg = dataclasses.replace(JC.get("phi4-mini-3.8b", smoke=True), dtype="float32",
                               qk_norm=True)
    tcfg = dataclasses.replace(TC.get("phi4-mini-3.8b", smoke=True), dtype="float32",
                               qk_norm=True)
    jp, _ = JL.init_attention(jax.random.key(3), jcfg)
    rng = np.random.default_rng(3)
    h = jcfg.resolved_head_dim
    jp = dict(jp, q_norm=jnp.asarray(1.0 + 0.3 * rng.standard_normal(h), jnp.float32),
              k_norm=jnp.asarray(1.0 + 0.3 * rng.standard_normal(h), jnp.float32))
    tp = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jp.items()}
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12))
    seen = []
    plain_watchers.append(_watch(seen))
    try:
        got, _ = TL.attention(tp, torch.from_numpy(x), tcfg,
                              positions=torch.from_numpy(pos.copy()))
    finally:
        plain_watchers.pop()
    want, _ = JL.attention(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert seen.count("rms_norm_ref") == 2 and seen.count("rotary_ref") == 2


def test_the_kv_norm_of_mla_matches_jax():
    """MLA's latent projection (deepseek-v2's smoke config, float32): c_kv,
    a 32-wide view in 48-wide rows, through B8's plain version at offset 0
    (with no copy on the card), and the rotated q_rope and k_rope, against
    JAX's ``_project_latents``."""
    from repro.models import transformer as JT
    from repro_torch.bridge import params_from_jax
    from repro_torch.models import mla as TM

    jcfg = dataclasses.replace(JC.get("deepseek-v2-236b", smoke=True), dtype="float32")
    tcfg = dataclasses.replace(TC.get("deepseek-v2-236b", smoke=True), dtype="float32")
    params, _ = JT.init_model(jax.random.key(1), jcfg)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    jp = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["attn"])
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6), (2, 6))
    want = JM._project_latents(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    got = TM._project_latents(model.layers[0]["attn"], torch.tensor(x), tcfg,
                              torch.tensor(pos.copy()))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the plan and the wrappers' contracts
# ---------------------------------------------------------------------------

# (rows, width) of every B8 call of the paths: 19c, 19h, MLA's c_kv, the
# qk-norm's rows of a head, the served decode rows, the smoke widths, odd
# widths in both layouts, a row of one
PATH_SHAPES = [(1024, 3072), (8192, 5120), (8192, 512), (24576, 128), (4, 3072), (4, 5120),
               (4, 512), (96, 192), (96, 32), (15, 77), (15, 1031), (64, 1024), (5, 1),
               (4096, 7168), (8, 2560), (32768, 3072)]


# the backward's partial d(scale) rows, written once and read once, at most
# this share of the bytes its bound counts (or a single partial row)
PART_SHARE = 1 / 5


def _kernel_for(width, elem_bytes, vec):
    """The rows kernel the plan's contract gives a row: a warp when 32
    threads hold its whole groups in registers, a block through the ring
    when eight warps do and the rows lie on 16 bytes, else
    ``rms_bwd_kernel_wide``."""
    whole = width // (kernel.VEC // elem_bytes)
    if whole <= 32 * kernel.MAX_ITEMS:
        return "warp"
    return "tma" if vec and whole <= kernel.TEAM_THREADS * kernel.MAX_ITEMS else "wide"


def _backward_plan_holds(plan, rows, width, elem_bytes, vec):
    """The backward plan's contract at one shape.  The kernels' strided row
    loops (row = block x teams + team, stepping by grid x teams) take every
    row once whatever the grid; the plan gives no block without rows, and
    each team at least ``ROWS_AHEAD`` rows (a ring block one) where the rows
    allow.  The grid within what the card holds at once and whole clusters
    of at most ``MAX_CLUSTER``; the kernel the row's width and alignment
    call for, its block within its limit; the threads' register groups
    covering the row's whole groups, no item more than needed; the shared
    rows one a team within ``MAX_SMEM``."""
    n = kernel.VEC // elem_bytes
    teams = plan.teams
    ahead = 1 if plan.stages else kernel.ROWS_AHEAD
    assert 1 <= plan.grid and (plan.grid - 1) * teams * ahead < max(rows, 1)
    assert plan.grid <= kernel.SMS * kernel.blocks_an_sm(plan, elem_bytes, vec)
    assert plan.cluster in (1, 2, 4, 8) and plan.cluster <= kernel.MAX_CLUSTER
    assert plan.grid % plan.cluster == 0 and plan.parts == plan.grid // plan.cluster
    assert plan.threads % 32 == 0 and plan.smem <= kernel.MAX_SMEM
    assert plan.kind == _kernel_for(width, elem_bytes, vec)
    if plan.stages:                          # the ring: a block a row, aligned rows
        assert vec and plan.items and 2 <= plan.stages <= kernel.STAGES
        assert plan.smem == plan.stages * (2 * width * elem_bytes + 8) + 4 * width
    else:
        assert plan.smem == 4 * width * teams
    whole = width // n
    if plan.warp:
        assert plan.threads == 32 * kernel.WARP_ROWS and teams == kernel.WARP_ROWS
    if plan.items:
        team_threads = 32 if plan.warp else plan.threads
        assert plan.threads <= kernel.TEAM_THREADS and 1 <= plan.items <= kernel.MAX_ITEMS
        assert plan.items * team_threads >= whole
        assert plan.items == 1 or (plan.items - 1) * team_threads < whole
    else:
        assert plan.threads == kernel.WIDE_THREADS and plan.cluster == 1 and teams == 1


@pytest.mark.parametrize("rows,width", PATH_SHAPES)
def test_the_plan_covers_every_row_once(rows, width):
    """The forward: a warp a row up to 1024 elements, eight rows a block;
    wider rows a block each of 64-512 threads, at most four 16-byte bf16
    groups a thread.  The backward, at both dtypes: the contract of
    :func:`_backward_plan_holds`; at bf16 (the paths' dtype at these
    shapes) every row in registers (no ``rms_bwd_kernel_wide``) and the
    partial rows' bytes within ``PART_SHARE`` of the bound's."""
    fwd = kernel.choose_launch(rows, width)
    assert fwd.warp == (width <= kernel.WARP_MAX) and fwd.threads % 32 == 0
    if fwd.warp:
        assert fwd.threads == 32 * kernel.WARP_ROWS
        assert (fwd.grid - 1) * kernel.WARP_ROWS < rows <= fwd.grid * kernel.WARP_ROWS
    else:
        assert fwd.grid == rows and 64 <= fwd.threads <= 512
        assert -(-width // 8) <= 4 * fwd.threads
    for elem_bytes in (2, 4):
        for vec in (True, False):
            _backward_plan_holds(kernel.choose_backward(rows, width, elem_bytes, vec), rows,
                                 width, elem_bytes, vec)
    bwd = kernel.choose_backward(rows, width, 2)
    bound_bytes = rows * width * 2 * 3 + rows * 4 + width * 8
    assert bwd.items > 0
    assert bwd.parts == 1 or bwd.parts * width * 4 * 2 <= PART_SHARE * bound_bytes


@pytest.mark.parametrize("elem_bytes,width", [(2, 8192), (2, 8200), (2, 9001), (4, 4096),
                                              (4, 4100), (4, 5120), (2, kernel.MAX_WIDTH)])
def test_a_width_beyond_the_register_plan_still_gets_a_plan(elem_bytes, width):
    """The widest aligned rows the registers hold (eight warps of four
    groups a thread) stay there; wider rows, and block rows not on 16
    bytes, take ``rms_bwd_kernel_wide``, a block a row with its d(scale)
    sums in shared memory, up to ``MAX_WIDTH``."""
    for rows, vec in ((3, True), (64, False), (8192, True)):
        plan = kernel.choose_backward(rows, width, elem_bytes, vec)
        _backward_plan_holds(plan, rows, width, elem_bytes, vec)
        inside = width // (kernel.VEC // elem_bytes) <= kernel.TEAM_THREADS * kernel.MAX_ITEMS
        assert (plan.items > 0) == (inside and vec)


def test_the_plan_is_a_function_of_the_shape_alone():
    assert kernel.choose_launch(8192, 5120) == kernel.choose_launch(8192, 5120)
    assert kernel.choose_backward(8192, 5120, 2) == kernel.choose_backward(8192, 5120, 2)
    for rows, width in ((-1, 8), (4, 0), (2**31, 8), (4, kernel.MAX_WIDTH + 1)):
        with pytest.raises(ValueError, match="rms_norm"):
            kernel.choose_launch(rows, width)
        with pytest.raises(ValueError, match="rms_norm"):
            kernel.choose_backward(rows, width, 2)
    with pytest.raises(ValueError, match="rms_norm"):
        kernel.choose_backward(4, 8, 8)


REFUSALS = ["float16 x", "float64 x", "bf16 scale", "scale's shape", "offset 0.5", "devices",
            "no row"]


@pytest.mark.parametrize("case", REFUSALS)
def test_the_wrapper_refuses(case):
    x, scale, offset = torch.zeros(4, 8), torch.zeros(8), 1.0
    if case == "float16 x":
        x = x.half()
    elif case == "float64 x":
        x = x.double()
    elif case == "bf16 scale":
        scale = scale.bfloat16()
    elif case == "scale's shape":
        scale = torch.zeros(9)
    elif case == "offset 0.5":
        offset = 0.5
    elif case == "devices":
        scale = scale.to("meta")
    elif case == "no row":
        x = torch.zeros(4, 0)
        scale = torch.zeros(0)
    with pytest.raises(ValueError, match="rms_norm"):
        kernel.rms_norm(x, scale, EPS, offset)


def test_the_backward_checks_dy_and_rstd():
    x, scale = torch.zeros(4, 8), torch.zeros(8)
    for rstd, dy in ((torch.zeros(3), torch.zeros(4, 8)), (torch.zeros(4).double(),
                                                            torch.zeros(4, 8)),
                     (torch.zeros(4), torch.zeros(4, 8).bfloat16()),
                     (torch.zeros(4), torch.zeros(4, 9))):
        with pytest.raises(ValueError, match="rms_norm"):
            backward.rms_norm_bwd(x, scale, rstd, dy, 1.0)


def test_rows_are_read_where_they_lie():
    """MLA's c_kv (512 of 576-wide rows) and a qk-norm head slice fold into
    one row stride: no copy.  A transposed tensor is copied once, counted."""
    before = kernel.layout_copies
    ckv = torch.zeros(2, 7, 576)[..., :512]
    rows = kernel.rows_of(ckv)
    assert rows.stride() == (576, 1) and rows.data_ptr() == ckv.data_ptr()
    q = torch.zeros(2, 7, 4, 128)
    assert kernel.rows_of(q).shape == (56, 128)
    assert kernel.layout_copies == before
    t = torch.zeros(8, 6).t()
    assert kernel.rows_of(t).is_contiguous() and kernel.layout_copies == before + 1


# ---------------------------------------------------------------------------
# the library call, over a fake library
# ---------------------------------------------------------------------------

class _FakeLibrary:
    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def rms_forward(self, *args):
        self.calls.append(("forward", args))
        return self.rc

    def rms_backward(self, *args):
        self.calls.append(("backward", args))
        return self.rc


@pytest.fixture
def fake_launch(monkeypatch):
    """The wrappers on CPU tensors up to the library call: the routing takes
    the card's branch, the stream is stubbed, the library is a fake."""
    lib = _FakeLibrary()
    monkeypatch.setattr(kernel, "takes_plain", lambda t: False)
    monkeypatch.setattr(backward, "takes_plain", lambda t: False)
    monkeypatch.setattr(kernel, "library", lambda device: lib)
    monkeypatch.setattr(kernel, "stream", lambda device: 0)
    return lib


class _RecordingTorch:
    """``torch`` for the backward wrapper, recording what ``torch.empty``
    allocates (the outputs and the partial rows' scratch)."""

    def __init__(self):
        self.empties = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def empty(self, *shape, **kw):
        t = torch.empty(*shape, **kw)
        self.empties.append(t)
        return t


def test_the_library_gets_the_tensors_own_pointers_and_the_plan(fake_launch, monkeypatch):
    recorded = _RecordingTorch()
    monkeypatch.setattr(backward, "torch", recorded)
    ckv = torch.zeros(2, 7, 576, dtype=torch.bfloat16)[..., :512]
    scale = torch.zeros(512)
    before = (kernel.launches, backward.launches, kernel.layout_copies)
    y, rstd = kernel.rms_norm(ckv, scale, EPS, 0.0)
    dy = torch.zeros(2, 7, 512, dtype=torch.bfloat16)
    dx, ds = backward.rms_norm_bwd(ckv, scale, rstd, dy, 0.0)
    assert (kernel.launches, backward.launches, kernel.layout_copies) == (
        before[0] + 1, before[1] + 1, before[2])
    (_, f), (_, b) = fake_launch.calls
    plan = kernel.choose_launch(14, 512)
    assert f[:5] == (ckv.data_ptr(), 576, 14, 512, scale.data_ptr())
    assert f[5:] == (0.0, EPS, 1, 1, 1, plan.threads, plan.grid, y.data_ptr(), rstd.data_ptr(),
                     0)
    assert y.shape == ckv.shape and y.is_contiguous() and rstd.shape == (2, 7)
    bplan = kernel.choose_backward(14, 512, 2)
    assert len(b) == 21
    assert b[:8] == (ckv.data_ptr(), 576, dy.data_ptr(), 512, rstd.data_ptr(), 14, 512,
                     scale.data_ptr())
    assert b[8:17] == (0.0, 1, 1, bplan.items, bplan.stages, bplan.threads, bplan.grid,
                       bplan.cluster, bplan.smem)
    assert b[17] == dx.data_ptr() and b[19] == ds.data_ptr() and ds.shape == (512,)
    assert b[20] == 0
    (partial,) = [t for t in recorded.empties if t.data_ptr() == b[18]]
    assert partial.shape == (bplan.parts, 512) and partial.dtype == torch.float32


@pytest.mark.parametrize("rows,width,dtype", [(1024, 3072, torch.bfloat16),
                                              (64, 7168, torch.bfloat16),
                                              (15, 1031, torch.bfloat16),
                                              (64, 5120, torch.float32),
                                              (3, 9001, torch.bfloat16)])
def test_the_backward_gets_its_plan_and_scratch(fake_launch, monkeypatch, rows, width, dtype):
    """At 19c's and Arctic's rows, an odd width, and two widths beyond the
    register plan (``rms_bwd_kernel_wide``): the library gets
    ``choose_backward``'s plan for x's dtype and a float32 scratch of one
    partial row a cluster."""
    recorded = _RecordingTorch()
    monkeypatch.setattr(backward, "torch", recorded)
    x = torch.zeros(rows, width, dtype=dtype)
    backward.rms_norm_bwd(x, torch.zeros(width), torch.zeros(rows), torch.zeros_like(x), 1.0)
    (_, b), = fake_launch.calls
    plan = kernel.choose_backward(rows, width, x.element_size(), bool(b[10]))
    assert b[9] == int(dtype == torch.bfloat16) and b[10] == int(width % 8 == 0)
    assert b[11:17] == (plan.items, plan.stages, plan.threads, plan.grid, plan.cluster,
                        plan.smem)
    assert plan.kind == _kernel_for(width, x.element_size(), bool(b[10]))
    (partial,) = [t for t in recorded.empties if t.data_ptr() == b[18]]
    assert partial.shape == (plan.parts, width) and partial.dtype == torch.float32


def test_the_vector_flag(fake_launch):
    """Rows on 16 bytes with whole groups read as vectors; a width off the
    group or a base off 16 bytes reads element by element; a base 16 bytes
    off still reads vectors."""
    scale = torch.zeros(64)
    kernel.rms_norm(torch.zeros(4, 64, dtype=torch.bfloat16), scale, EPS, 1.0)
    kernel.rms_norm(torch.zeros(4, 7), torch.zeros(7), EPS, 1.0)
    kernel.rms_norm(torch.zeros(4 * 64 + 1, dtype=torch.bfloat16)[1:].view(4, 64), scale, EPS,
                    1.0)
    kernel.rms_norm(torch.zeros(4 * 64 + 8, dtype=torch.bfloat16)[8:].view(4, 64), scale, EPS,
                    1.0)
    assert [c[1][8] for c in fake_launch.calls] == [1, 0, 0, 1]


def test_a_failed_launch_raises_and_never_falls_back(fake_launch, monkeypatch):
    def plain(*a, **kw):
        raise AssertionError("a plain version was called for a kernel launch")

    monkeypatch.setattr(kernel, "rms_norm_ref", plain)
    monkeypatch.setattr(backward, "rms_norm_bwd_ref", plain)
    fake_launch.rc = 700                                 # cudaErrorIllegalAddress
    x, scale = torch.zeros(4, 8), torch.zeros(8)
    before = (kernel.launches, backward.launches)
    with pytest.raises(RuntimeError, match="rms_forward launch failed: CUDA error 700"):
        kernel.rms_norm(x, scale, EPS, 1.0)
    with pytest.raises(RuntimeError, match="rms_backward launch failed: CUDA error 700"):
        backward.rms_norm_bwd(x, scale, torch.zeros(4), torch.zeros(4, 8), 1.0)
    assert (kernel.launches, backward.launches) == before and len(fake_launch.calls) == 2


def test_no_rows_launch_and_count_nothing(fake_launch):
    before = (kernel.launches, backward.launches)
    y, rstd = kernel.rms_norm(torch.zeros(0, 8), torch.zeros(8), EPS, 1.0)
    dx, ds = backward.rms_norm_bwd(torch.zeros(0, 8), torch.zeros(8), rstd, torch.zeros(0, 8),
                                   1.0)
    assert y.shape == dx.shape == (0, 8) and rstd.shape == (0,) and torch.equal(ds, torch.zeros(8))
    assert not fake_launch.calls and (kernel.launches, backward.launches) == before


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _watch(seen):
    inner = plain_watchers[-1] if plain_watchers else (lambda fn, args, writes=(): fn(*args))

    def watcher(fn, args, writes=()):
        seen.append(getattr(fn, "func", fn).__name__)
        return inner(fn, args, writes)

    return watcher


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_cpu_and_meta_take_the_plain_versions_through_run_plain(device):
    """One ``run_plain`` a call (the one launch it stands for), forward and
    backward; no launch is counted."""
    x = torch.randn(3, 4, 48, device=device, requires_grad=True)
    scale = torch.randn(48, device=device, requires_grad=True)
    seen = []
    plain_watchers.append(_watch(seen))
    before = (kernel.launches, backward.launches)
    try:
        y = TL.apply_norm({"scale": scale}, x, _cfg())
        y.backward(torch.ones_like(y))
    finally:
        plain_watchers.pop()
    assert seen == ["rms_norm_ref", "rms_norm_bwd_ref"]
    assert (kernel.launches, backward.launches) == before
    assert x.grad.shape == x.shape and scale.grad.shape == scale.shape


def test_layernorm_is_not_b8():
    seen = []
    plain_watchers.append(_watch(seen))
    try:
        TL.apply_norm({"scale": torch.ones(8), "bias": torch.zeros(8)}, torch.randn(2, 8), _cfg())
    finally:
        plain_watchers.pop()
    assert seen == []


def test_a_dtensor_is_refused_by_the_wrapper():
    from repro_torch.distributed import place

    with dryrun.fake_mesh((1, 1), ("data", "model")) as mesh:
        from torch.distributed.tensor import Replicate

        x = place(torch.zeros(4, 8), mesh, [Replicate(), Replicate()])
        with pytest.raises(TypeError, match="local_map"):
            kernel.rms_norm(x, torch.zeros(8), EPS, 1.0)


def sharded_norm(mesh, shape, x, scale, dy):
    """On one rank of a gloo mesh: x sharded on its rows (batch over "data",
    sequence over "model"), scale replicated; y, x's and scale's gradients
    gathered whole, and the collectives of the forward."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import place
    from repro_torch.launch.comm_analysis import CommCounter

    xs = place(torch.tensor(x), mesh, [Shard(0), Shard(1)]).requires_grad_()
    ss = place(torch.tensor(scale), mesh, [Replicate(), Replicate()]).requires_grad_()
    with CommCounter() as counter:
        y = ops.rms_norm(xs, ss, eps=EPS, offset=1.0)
    d = place(torch.tensor(dy), mesh, list(y.placements))
    gx, gs = torch.autograd.grad(y, (xs, ss), d)
    return dict(y=y.full_tensor().detach().numpy(), gx=gx.full_tensor().numpy(),
                gs=gs.full_tensor().numpy(), placements=[str(p) for p in y.placements],
                forward=[r for r in counter.records if r[0] != "wait_tensor"])


@pytest.mark.timeout(300)
@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_a_dtensor_runs_on_its_local_rows(tmp_path, shape):
    """``ops.rms_norm`` of a DTensor sharded on its rows: each rank's rows
    through ``local_map``, no collective in the forward, y sharded as x;
    y and both gradients as the unsharded call's."""
    x, scale, dy = _inputs(48, seed=9, lead=(2, 6))
    got = run_mesh(shape, sharded_norm, (x, scale, dy), tmp_path)
    tx = torch.tensor(x, requires_grad=True)
    ts = torch.tensor(scale, requires_grad=True)
    y = ops.rms_norm(tx, ts, eps=EPS, offset=1.0)
    y.backward(torch.tensor(dy))
    np.testing.assert_allclose(got["y"], y.detach().numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["gx"], tx.grad.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["gs"], ts.grad.numpy(), rtol=1e-5, atol=1e-5)
    assert got["placements"] == ["S(0)", "S(1)"] and got["forward"] == []


# ---------------------------------------------------------------------------
# the dry run's count, and chip_smoke's cases
# ---------------------------------------------------------------------------

def test_each_launch_counts_its_inputs_and_outputs_once():
    """On meta tensors, R rows of width D in bf16: the forward reads x and
    scale and writes y and rstd; the backward reads x, scale, rstd and dy
    and writes dx and dscale.  The plain versions' float32 intermediates
    are not the kernel's."""
    R, D = 64, 1000
    x = torch.empty(R, D, dtype=torch.bfloat16, device="meta")
    dy = torch.empty(R, D, dtype=torch.bfloat16, device="meta")
    scale, rstd = torch.empty(D, device="meta"), torch.empty(R, device="meta")
    with torch.no_grad():
        fwd = dryrun.count_step(lambda: kernel.rms_norm(x, scale, EPS, 1.0))
        bwd = dryrun.count_step(lambda: backward.rms_norm_bwd(x, scale, rstd, dy, 1.0))
    assert fwd["bytes_accessed"] == 2 * R * D + 4 * D + 2 * R * D + 4 * R
    assert bwd["bytes_accessed"] == 2 * R * D + 4 * D + 4 * R + 2 * R * D + 2 * R * D + 4 * D


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase_3e_covers_the_paths_shapes():
    """3e holds B8 at 19c's and 19h's rows, c_kv in its 576-wide rows, the
    qk-norm's head rows, the decode rows, float32, both layouts at odd
    widths, a base 16 and 2 bytes off, and a row of one; and times 19c's
    and 19h's rows."""
    c = _chip_smoke()
    cases = {(int(np.prod(lead)), w, st, dt, base) for _, lead, w, st, dt, _, base in
             c.NORM_CASES}
    for must in ((1024, 3072, None, "bfloat16", 0), (8192, 5120, None, "bfloat16", 0),
                 (8192, 512, 576, "bfloat16", 0), (24576, 128, None, "bfloat16", 0),
                 (4, 3072, None, "bfloat16", 0), (64, 3072, None, "bfloat16", 8),
                 (64, 3072, None, "bfloat16", 1), (5, 1, None, "float32", 0)):
        assert must in cases
    widths = {w for _, _, w, *_ in c.NORM_CASES}
    assert any(w % 8 and w <= kernel.WARP_MAX for w in widths)
    assert any(w % 8 and w > kernel.WARP_MAX for w in widths)
    assert {c.NORM_CASES[i][1:3] for i in c.NORM_TIMED} == {((2, 512), 3072), ((2, 4096), 5120)}
    assert c.NORM_EPS == TC.get("phi4-mini-3.8b").norm_eps == TC.get("deepseek-v2-236b").norm_eps
