"""Plain versions of the port's kernels against the Pallas kernels
(interpret mode on the CPU), and on a card each CUDA kernel against its
plain version.  The card cases run where JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels.py

Tolerances:
- GRU f32: 2e-5, as tests/test_gru_pallas.py (sum order only).  dts stay
  below 100 as there: XLA on the CPU contracts ``dts*tw + tb`` into one
  FMA while the port rounds product and sum separately, which at |arg|
  ~1e6 moves cos by up to ~0.25 (at < 100, by < 1e-5).
- GRU bf16: 1e-3.  Both sides round the same operands to bf16 and
  accumulate in f32, but a tf value that the FMA above moves across a
  bf16 rounding boundary rounds to the neighbouring bf16 value (2^-8
  relative), which moves h by up to ~4e-4 (measured; 10 of 51,200 values).
- attention f32: 1e-5 (tests/test_attention_pallas.py).
- attention bf16: 5e-2 abs + 5e-2 rel.  The Pallas kernel multiplies and
  sums q*k in bf16; the port accumulates in f32.
- GRU backward, per gradient, as max abs error over max abs value: f32
  1e-5 (sum order over 700 rows; dts < 100 as above, for sin); bf16 1e-3.
  Both sides round the same da to bf16, but a da that the forward's sum
  order moves across a bf16 rounding boundary, or a tf moved there by the
  FMA above, rounds to the neighbouring bf16 value (2^-8 relative), and
  each gradient sums such products over all rows.
- attention backward f32: 1e-5 (the same plain ops on both sides).
- segment sum (K4), on the card: max abs error over max abs value 1e-5;
  the kernel adds in row order, the plain version's CUDA ``index_add_``
  in the order its atomics land.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gnnflow_tpu_torch.models.modules import masked_softmax
from gnnflow_tpu_torch.ops import segment_sum as segment_sum_mod
from gnnflow_tpu_torch.ops.attention_fused import (
    neighborhood_attention, neighborhood_attention_autograd,
    neighborhood_attention_ref, plan)
from gnnflow_tpu_torch.ops.gru_fused import (
    gru_memory_fused, gru_memory_fused_autograd, gru_memory_fused_bwd,
    gru_memory_fused_bwd_ref, gru_memory_fused_ref)
from gnnflow_tpu_torch.ops.segment_sum import (expand_compact,
                                               sorted_segment_sum,
                                               sorted_segment_sum_ref)
from torch_fixtures import cuda, one_cpu_thread  # noqa: F401

GRAD_NAMES = ("dki", "dbi", "dkh", "dbh", "dtw", "dtb")


def _gru_inputs(n, f=100, dr=372, dt=100, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(n, f) * 0.5).astype(np.float32),
            (rng.randn(n, dr) * 0.5).astype(np.float32),
            (rng.rand(n) * 100).astype(np.float32),
            (rng.randn(dr + dt, 3 * f) * 0.05).astype(np.float32),
            (rng.randn(3 * f) * 0.05).astype(np.float32),
            (rng.randn(f, 3 * f) * 0.05).astype(np.float32),
            (rng.randn(3 * f) * 0.05).astype(np.float32),
            (1.0 / 10 ** np.linspace(0, 9, dt)).astype(np.float32),
            (rng.randn(dt) * 0.1).astype(np.float32)]


def _attention_inputs(B=300, F=10, H=2, dh=50, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, dh).astype(np.float32)
    k = rng.randn(B, F, H, dh).astype(np.float32)
    v = rng.randn(B, F, H, dh).astype(np.float32)
    mask = rng.rand(B, F) < 0.7
    if B > 3:
        mask[3] = False                  # one row fully masked
    return q, k, v, mask


@pytest.fixture(scope="module")
def jref():
    """The JAX package's kernels (JAX is absent on the card's machine)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from gnnflow_tpu.models.modules import masked_softmax
    from gnnflow_tpu.ops.attention_pallas import neighborhood_attention
    from gnnflow_tpu.ops.gru_pallas import _call_bwd, gru_memory_fused
    return SimpleNamespace(jax=jax, jnp=jnp, gru=gru_memory_fused,
                           gru_bwd=_call_bwd,
                           attention=neighborhood_attention,
                           masked_softmax=masked_softmax)


# (compute dtype, mem/mail as pulled, tolerance); "bf16 pull" is the main
# path: memory and mails arrive rounded to bf16
GRU_CASES = {"f32": (None, np.float32, 2e-5),
             "bf16": ("bfloat16", np.float32, 1e-3),
             "bf16 pull": ("bfloat16", "bf16", 1e-3)}


# odd widths: no dimension a multiple of 8 or 16, as the card's tiles pad
ODD = dict(f=37, dr=13, dt=5)


@pytest.mark.parametrize("case", list(GRU_CASES))
@pytest.mark.parametrize("n,widths", [(512, {}), (1000, {}), (300, ODD)],
                         ids=["512", "1000", "odd"])   # whole, ragged tiles
def test_gru_ref_matches_pallas(jref, n, widths, case):
    jnp = jref.jnp
    cd, state_dtype, tol = GRU_CASES[case]
    args = _gru_inputs(n, **widths)
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    if state_dtype == "bf16":
        jargs[:2] = [a.astype(jnp.bfloat16) for a in jargs[:2]]
        targs[:2] = [a.bfloat16() for a in targs[:2]]
    want = np.asarray(jref.gru(*jargs, cd, 512, True))
    got = gru_memory_fused_ref(*targs, cd)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    # on the CPU the wrapper is the plain version
    assert torch.equal(gru_memory_fused(*targs, cd), got)


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize(
    "case,widths", [(c, {}) for c in GRU_CASES] + [(c, ODD) for c in GRU_CASES],
    ids=list(GRU_CASES) + [f"{c}-odd" for c in GRU_CASES])
def test_gru_bwd_ref_matches_pallas(jref, case, widths):
    """K2's plain version against the Pallas backward kernel, with 700
    rows: one whole 512-row tile and one ragged tile."""
    jnp = jref.jnp
    cd, state_dtype, _ = GRU_CASES[case]
    tol = 1e-5 if cd is None else 1e-3
    n = 700
    args = _gru_inputs(n, seed=3, **widths)
    dh = (np.random.RandomState(4).randn(n, widths.get("f", 100))
          .astype(np.float32))
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    if state_dtype == "bf16":
        jargs[:2] = [a.astype(jnp.bfloat16) for a in jargs[:2]]
        targs[:2] = [a.bfloat16() for a in targs[:2]]
    want = jref.gru_bwd(*jargs, jnp.asarray(dh), cd, 512, True)
    got = gru_memory_fused_bwd_ref(*targs, torch.from_numpy(dh), cd)
    for name, g, w in zip(GRAD_NAMES, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert _rel_err(g.numpy(), w) <= tol, (name, _rel_err(g.numpy(), w))
    # on the CPU the wrapper is the plain version
    for g, w in zip(gru_memory_fused_bwd(*targs, torch.from_numpy(dh), cd),
                    got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_gru_autograd_reaches_parameters_only(cd):
    """The autograd function gives the f32 parameters K2's gradients and
    mem, mail and dts none (gru_pallas.py:33-38)."""
    args = [torch.from_numpy(a) for a in _gru_inputs(300, seed=5)]
    mem, mail, dts, ki, bi, kh, bh, tw, tb = args
    for t in args:
        t.requires_grad_()
    cdt = getattr(torch, cd) if cd else torch.float32
    ki_c, kh_c = ki.detach().to(cdt), kh.detach().to(cdt)
    h = gru_memory_fused_autograd(mem, mail, dts, ki, bi, kh, bh, tw, tb,
                                  ki_c, kh_c, cd)
    dh = torch.from_numpy(np.random.RandomState(6).randn(300, 100)
                          .astype(np.float32))
    h.backward(dh)
    assert mem.grad is None and mail.grad is None and dts.grad is None
    want = gru_memory_fused_bwd_ref(*[a.detach() for a in args], dh, cd)
    for name, p, w in zip(GRAD_NAMES, (ki, bi, kh, bh, tw, tb), want):
        assert p.grad.dtype == torch.float32, name
        assert torch.equal(p.grad, w), name
    with torch.no_grad():
        assert torch.equal(h, gru_memory_fused_ref(
            *[a.detach() for a in args], cd))


def test_attention_backward_matches_jax_vjp(jref):
    """dq, dk, dv of the autograd function (CPU: the plain version) against
    jax.vjp of the Pallas op in interpret mode; fully masked rows get zero
    gradients and no NaN."""
    jnp = jref.jnp
    q, k, v, mask = _attention_inputs(B=200)
    mask[7] = False
    dout = np.random.RandomState(9).randn(*q.shape).astype(np.float32)
    _, vjp = jref.jax.vjp(lambda a, b, c: jref.attention(
        a, b, c, jnp.asarray(mask), True), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = neighborhood_attention_autograd(tq, tk, tv, torch.from_numpy(mask))
    out.backward(torch.from_numpy(dout))
    for name, t, w in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        g = t.grad.numpy()
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
        assert not g[3].any() and not g[7].any(), name


# (B, F, H, dh) beside the main shape (300, 10, 2, 50): K3's odd shapes,
# including one destination, a single slot, 32 slots and heads of 5 and
# 128 columns.  In bf16 the Pallas kernel sums q*k in bf16, so its error
# grows with dh: the bf16 cases keep dh <= 50.
ATTENTION_SHAPES = [
    pytest.param("float32", 1e-5, (300, 10, 2, 50), id="float32-1e-05"),
    pytest.param("bfloat16", 5e-2, (300, 10, 2, 50), id="bfloat16-0.05"),
    pytest.param("float32", 1e-5, (1, 1, 1, 37), id="float32-1-1-1-37"),
    pytest.param("float32", 1e-5, (33, 32, 3, 5), id="float32-33-32-3-5"),
    pytest.param("float32", 1e-5, (33, 10, 4, 128),
                 id="float32-33-10-4-128"),
    pytest.param("bfloat16", 5e-2, (33, 32, 3, 5),
                 id="bfloat16-33-32-3-5"),
    pytest.param("bfloat16", 5e-2, (1000, 1, 1, 37),
                 id="bfloat16-1000-1-1-37"),
]


@pytest.mark.parametrize("dtype,tol,shape", ATTENTION_SHAPES)
def test_attention_ref_matches_pallas(jref, dtype, tol, shape):
    jnp = jref.jnp
    q, k, v, mask = _attention_inputs(*shape)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jref.attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                                 jnp.asarray(v, jd), jnp.asarray(mask),
                                 True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    got = neighborhood_attention_ref(tq, tk, tv, torch.from_numpy(mask))
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)
    if len(mask) > 3:
        assert not got[3].any()          # fully masked row is exactly 0
    assert torch.equal(
        neighborhood_attention(tq, tk, tv, torch.from_numpy(mask)), got)


def test_masked_softmax_matches_jax(jref):
    jnp = jref.jnp
    rng = np.random.RandomState(2)
    s = rng.randn(40, 6, 2).astype(np.float32)
    m = rng.rand(40, 6, 1) < 0.6
    m[5] = False
    want = np.asarray(jref.masked_softmax(jnp.asarray(s), jnp.asarray(m),
                                          1))
    got = masked_softmax(torch.from_numpy(s), torch.from_numpy(m), 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def _k3_operands(B, F, H, dh, dtype, fused, device="cpu", seed=0):
    """q, k, v, mask for K3: k and v as column slices of one fused [B, F,
    2*H*dh] projection (as the layer has them) or as two tensors.  Row 0
    has no valid slot and row 1 one (the last), where B allows."""
    g = torch.Generator().manual_seed(seed)
    D = H * dh
    q = torch.randn(B, H, dh, generator=g).to(device, dtype)
    if fused:
        kv = torch.randn(B, F, 2 * D, generator=g).to(device, dtype)
        k = kv[..., :D].reshape(B, F, H, dh)
        v = kv[..., D:].reshape(B, F, H, dh)
    else:
        k = torch.randn(B, F, H, dh, generator=g).to(device, dtype)
        v = torch.randn(B, F, H, dh, generator=g).to(device, dtype)
    mask = torch.rand(B, F, generator=g) < 0.7
    mask[::7] = False
    if B > 1:
        mask[1] = False
        mask[1, F - 1] = True
    return q, k, v, mask.to(device)


# (B, F, H, dh, dtype, fused) -> the plan's path, fusion, copy widths,
# lanes a head and slot groups
PLANS = [
    # the TGN main path: one 16-byte copy of k|v a slot, q rows of 200
    # bytes; in bf16 two slot groups of 16 lanes, 8 lanes a head
    ((12, 10, 2, 50, torch.bfloat16, True), (1, 1, 16, 8, 8, 2)),
    ((12, 10, 2, 50, torch.float32, True), (1, 1, 16, 16, 16, 1)),
    # separate k and v: two copies a slot, of 200 bytes
    ((12, 10, 2, 50, torch.bfloat16, False), (1, 0, 8, 8, 8, 2)),
    # 74-byte q rows allow no 4-byte copy: the direct path; in f32 the
    # 296-byte k|v rows take 8-byte copies and the q rows 4-byte ones, and
    # an odd dh keeps one slot group
    ((12, 10, 1, 37, torch.bfloat16, True), (0, 1, 4, 0, 32, 1)),
    ((12, 10, 1, 37, torch.float32, True), (1, 1, 8, 4, 32, 1)),
    ((12, 32, 3, 5, torch.float32, False), (1, 0, 4, 4, 8, 1)),
    # 32 slots of 4 KB (f32) do not fit twice in shared memory; 4 heads of
    # 128 columns fill the warp
    ((12, 32, 4, 128, torch.float32, True), (0, 1, 16, 16, 32, 1)),
    ((12, 32, 4, 128, torch.bfloat16, True), (1, 1, 16, 16, 32, 1)),
]


@pytest.mark.parametrize("shape,want", PLANS,
                         ids=[f"{b}-{f}-{h}-{d}-{str(t)[6:]}-"
                              f"{'fused' if fu else 'apart'}"
                              for (b, f, h, d, t, fu), _ in PLANS])
def test_attention_plan(shape, want):
    """K3's path and layout follow the tensors' strides and addresses; a
    staged layout fits the shared-memory budget twice a warp."""
    *dims, dtype, fused = shape
    q, k, v, _ = _k3_operands(*dims, dtype, fused)
    out = torch.empty_like(q)
    pl = plan(q, k, v, out)
    got = (pl["staged"], pl["fused"], pl["w_kv"], pl["w_q"],
           pl["lanes_per_head"], pl["slot_groups"])
    assert got == want
    B, F, H, dh = dims
    sg, g = pl["slot_groups"], pl["lanes_per_head"]
    assert 4 * sg * g >= dh and sg * g <= 32
    if pl["staged"]:
        row = H * dh * q.element_size()
        assert pl["pitch"] % 16 == 0 and pl["pitch"] >= 2 * row
        assert pl["v_off"] * q.element_size() + row <= pl["pitch"]
        assert 1 <= pl["warps"] <= 4 and pl["smem"] <= 200 * 1024
        assert pl["slots"] >= F and pl["slots"] in (8, 10, 16, 32)
        assert pl["smem"] == pl["warps"] * 2 * (pl["q_pitch"]
                                                + pl["slots"] * pl["pitch"])
    # every destination has a warp: 4 a staged warp, 1 a direct one
    per_warp = 4 if pl["staged"] else 1
    assert pl["blocks"] * pl["warps"] * per_warp >= B
    assert (pl["blocks"] - 1) * pl["warps"] * per_warp < B


# the card's tiles take 64 rows and pad K and the gate columns to 16 and 8:
# one row, a part tile, ragged tiles, and odd widths
CARD_SHAPES = [(1, {}), (63, {}), (1000, {}), (4097, {}), (1000, ODD)]
CARD_IDS = ["1", "63", "1000", "4097", "1000-odd"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRU_CASES))
@pytest.mark.parametrize("n,widths", CARD_SHAPES, ids=CARD_IDS)
def test_gru_kernel_matches_plain_on_card(cuda, n, widths, case):
    cd, state_dtype, _ = GRU_CASES[case]
    args = [torch.from_numpy(a).to(cuda)
            for a in _gru_inputs(n, **widths)]
    args[2][::7] *= 2.7e4                # stream-sized dts, up to ~2.7e6
    if state_dtype == "bf16":
        args[:2] = [a.bfloat16() for a in args[:2]]
    if cd is not None:                   # the kernel takes ki, kh in cd
        cdt = getattr(torch, cd)
        args[3], args[5] = args[3].to(cdt), args[5].to(cdt)
    before = gru_memory_fused.launches
    got = gru_memory_fused(*args, cd)
    torch.cuda.synchronize()
    assert gru_memory_fused.launches == before + 1
    want = gru_memory_fused_ref(*args, cd)
    # f32: sum order; bf16: neighbouring bf16 roundings of tf
    tol = 5e-5 if cd is None else 2e-3
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernel_matches_plain_on_card(cuda, dtype):
    q, k, v, mask = _attention_inputs(B=1000)
    td = getattr(torch, dtype)
    q = torch.from_numpy(q).to(cuda, td)
    # k and v as column slices of one fused projection, as the layer has
    kv = torch.cat([torch.from_numpy(k).reshape(1000, 10, 100),
                    torch.from_numpy(v).reshape(1000, 10, 100)], -1) \
        .to(cuda, td)
    k, v = kv[..., :100].reshape(1000, 10, 2, 50), \
        kv[..., 100:].reshape(1000, 10, 2, 50)
    mask = torch.from_numpy(mask).to(cuda)
    before = neighborhood_attention.launches
    got = neighborhood_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert neighborhood_attention.launches == before + 1
    want = neighborhood_attention_ref(q, k, v, mask)
    # f32: sum order; bf16: one bf16 ulp of the output (2^-7 relative)
    tol = (1e-5, 1e-5) if dtype == "float32" else (2 ** -6, 1e-5)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0],
                               atol=tol[1])
    assert not got[3].any()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 33, 1000])
@pytest.mark.parametrize("H,dh", [(2, 50), (1, 37), (4, 128), (3, 5)])
@pytest.mark.parametrize("F", [1, 10, 32])
def test_attention_kernel_odd_shapes_on_card(cuda, F, H, dh, B):
    """K3 against its plain version at odd shapes, in both dtypes, with k
    and v fused (the staged path where alignment allows) and apart (the
    narrower copies or the direct path); fully masked rows exactly 0, a
    single valid slot, and two launches bit-identical."""
    for dtype in (torch.float32, torch.bfloat16):
        for fused in (True, False):
            q, k, v, mask = _k3_operands(B, F, H, dh, dtype, fused,
                                         device=cuda, seed=B + F + dh)
            before = neighborhood_attention.launches
            got = neighborhood_attention(q, k, v, mask)
            again = neighborhood_attention(q, k, v, mask)
            torch.cuda.synchronize()
            assert neighborhood_attention.launches == before + 2
            what = (str(dtype), fused, plan(q, k, v, got))
            assert torch.equal(got, again), what
            want = neighborhood_attention_ref(q, k, v, mask)
            # f32: sum order; bf16: one bf16 ulp of the output
            tol = (1e-5, 1e-5) if dtype == torch.float32 \
                else (2 ** -6, 1e-5)
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=tol[0], atol=tol[1],
                                       msg=lambda m: f"{what}: {m}")
            empty = ~mask.any(1)
            assert not got[empty].any(), what


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRU_CASES))
@pytest.mark.parametrize("n,widths", CARD_SHAPES, ids=CARD_IDS)
def test_gru_bwd_kernel_matches_plain_on_card(cuda, n, widths, case):
    """K2 against its plain version on the card, at dts up to ~2.7e6, and
    two launches bit-identical (no float atomics)."""
    cd, state_dtype, _ = GRU_CASES[case]
    args = [torch.from_numpy(a).to(cuda)
            for a in _gru_inputs(n, seed=2, **widths)]
    args[2][::7] *= 2.7e4
    if state_dtype == "bf16":
        args[:2] = [a.bfloat16() for a in args[:2]]
    if cd is not None:
        cdt = getattr(torch, cd)
        args[3], args[5] = args[3].to(cdt), args[5].to(cdt)
    dh = torch.randn(n, args[0].shape[1], device=cuda,
                     generator=torch.Generator(cuda).manual_seed(1))
    before = gru_memory_fused_bwd.launches
    got = gru_memory_fused_bwd(*args, dh, cd)
    again = gru_memory_fused_bwd(*args, dh, cd)
    torch.cuda.synchronize()
    assert gru_memory_fused_bwd.launches == before + 2
    want = gru_memory_fused_bwd_ref(*args, dh, cd)
    # f32: sum order; bf16: neighbouring bf16 roundings of da and tf
    tol = 1e-4 if cd is None else 1e-3
    for name, g, a, w in zip(GRAD_NAMES, got, again, want):
        assert torch.equal(g, a), name
        err = ((g - w).abs().max() / w.abs().max()).item()
        assert err <= tol, (name, err)


def _segments(L, cap, D, seed, tail=0):
    """Non-decreasing ranks with empty ranks in the middle and at the end,
    a hot pair of 200 rows, and the last ``tail`` rows on one rank (as the
    dedup's invalid instances); and rows to sum."""
    rng = np.random.RandomState(seed)
    seg = np.sort(rng.randint(0, cap - 7, L)).astype(np.int32)
    seg[L // 3: L // 3 + 200] = seg[L // 3]
    seg = np.sort(seg)
    if tail:
        seg[L - tail:] = seg[L - tail - 1]
    return seg, rng.randn(L, D).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("L,cap,D,tail", [
    (5000, 2000, 100, 0), (3000, 700, 128, 0), (1000, 300, 37, 0),
    (2000, 500, 300, 0), (60_000, 9000, 100, 40_000), (63, 40, 100, 0)])
def test_segment_sum_kernel_matches_plain_on_card(cuda, L, cap, D, tail):
    seg, dhs = _segments(L, cap, D, seed=L, tail=tail)
    seg, dhs = torch.from_numpy(seg).to(cuda), torch.from_numpy(dhs).to(cuda)
    before = sorted_segment_sum.launches
    got = sorted_segment_sum(dhs, seg, cap)
    again = sorted_segment_sum(dhs, seg, cap)
    torch.cuda.synchronize()
    assert sorted_segment_sum.launches == before + 2
    assert torch.equal(got, again)           # no atomics
    # the plain version in f64, so that its atomics' order does not show;
    # each value is also held to the sum of its terms' magnitudes, the
    # scale of f32 summation error, so short segments are held tightly
    want = sorted_segment_sum_ref(dhs.double(), seg, cap)
    err = (got.double() - want).abs()
    assert (err.max() / want.abs().max()).item() <= 1e-5
    abs_sum = sorted_segment_sum_ref(dhs.abs().double(), seg, cap)
    assert (err / abs_sum.clamp_min(1e-300)).max().item() <= 1e-5
    assert not got[cap - 7:].any()


@pytest.mark.cuda
def test_expand_compact_backward_launches_k4_on_card(cuda):
    seg, dh = _segments(4000, 1500, 100, seed=1)
    sidx = torch.from_numpy(np.random.RandomState(2).permutation(4000)) \
        .to(cuda)
    rank = torch.from_numpy(seg).to(cuda)
    inv = torch.empty_like(sidx)
    inv[sidx] = rank.long()
    up = torch.randn(1500, 100, device=cuda, requires_grad=True)
    before = sorted_segment_sum.launches
    out = expand_compact(up, inv, sidx, rank)
    dh = torch.from_numpy(dh).to(cuda)
    out.backward(dh)
    torch.cuda.synchronize()
    assert sorted_segment_sum.launches == before + 1
    assert torch.equal(out, up.detach()[inv])
    want = torch.zeros_like(up, dtype=torch.float64) \
        .index_add_(0, inv, dh.double())
    assert ((up.grad.double() - want).abs().max()
            / want.abs().max()).item() <= 1e-5


def _odd_segments(case, tile):
    """(seg, cap, D) of K4's edge cases; ``tile`` is the kernel's tile."""
    rng = np.random.RandomState(7)
    if case == "one segment":              # every row on one rank
        return np.full(5000, 5, np.int32), 12, 100
    if case == "tile-long segment":        # rows [tile, 2 tile) on one rank
        seg = np.sort(rng.randint(0, 900, 3 * tile)).astype(np.int32)
        seg[tile:2 * tile] = seg[tile]
        seg[2 * tile:] = np.maximum(seg[2 * tile:], seg[tile] + 1)
        return seg, 1000, 100
    if case == "long segment from a tile edge":
        seg = np.sort(rng.randint(0, 400, 20 * tile + 77)).astype(np.int32)
        seg[2 * tile:15 * tile + 5] = seg[2 * tile]
        seg[15 * tile + 5:] = np.maximum(seg[15 * tile + 5:],
                                         seg[2 * tile] + 1)
        return seg, 500, 100
    if case == "clamped":                  # n_uniq > cap: the tail on cap-1
        cap = 3000
        steps = rng.rand(20_000) < 0.5
        return (np.minimum(np.cumsum(steps), cap - 1).astype(np.int32),
                cap, 100)
    D = int(case.split()[1])               # "D 1", "D 4", "D 257"
    seg = np.sort(rng.randint(3, 690, 3000)).astype(np.int32)
    seg[1000:1700] = seg[1000]
    return seg, 700, D


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "one segment", "tile-long segment", "long segment from a tile edge",
    "clamped", "D 1", "D 4", "D 257"])
def test_segment_sum_kernel_edge_cases_on_card(cuda, case):
    """K4 against its plain version (f64) where segments cross tiles in
    every way, for widths without 16-byte rows, and when the dedup's
    clamp puts many rows on rank cap - 1; ranks no row carries are 0."""
    tile = segment_sum_mod._lib().segment_sum_tile_rows()
    seg, cap, D = _odd_segments(case, tile)
    dhs = np.random.RandomState(8).randn(len(seg), D).astype(np.float32)
    seg, dhs = torch.from_numpy(seg).to(cuda), torch.from_numpy(dhs).to(cuda)
    got = sorted_segment_sum(dhs, seg, cap)
    again = sorted_segment_sum(dhs, seg, cap)
    torch.cuda.synchronize()
    assert torch.equal(got, again)           # no atomics
    want = sorted_segment_sum_ref(dhs.double(), seg, cap)
    err = (got.double() - want).abs()
    assert (err.max() / want.abs().max()).item() <= 1e-5
    abs_sum = sorted_segment_sum_ref(dhs.abs().double(), seg, cap)
    assert (err / abs_sum.clamp_min(1e-300)).max().item() <= 1e-5
    empty = torch.bincount(seg.long(), minlength=cap) == 0
    assert empty.any() or case == "clamped"
    assert not got[empty].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernel_at_tgat_inner_layer_on_card(cuda, dtype):
    """K3 at TGAT's inner layer at batch 4000: 132,000 destinations, 10
    slots, 2 heads of 50, k and v column slices of one fused projection;
    every q row the same (the query of TE(0) alone, contiguous), and a
    uniform-sampling mask: a row is all valid or all masked."""
    B, F, H, dh = 132_000, 10, 2, 50
    td = getattr(torch, dtype)
    gen = torch.Generator(cuda).manual_seed(4)
    q = torch.randn(1, H, dh, device=cuda, generator=gen).to(td) \
        .expand(B, H, dh).contiguous()
    kv = torch.randn(B, F, 4 * dh, device=cuda, generator=gen).to(td)
    k, v = kv[..., :H * dh].reshape(B, F, H, dh), \
        kv[..., H * dh:].reshape(B, F, H, dh)
    mask = (torch.rand(B, device=cuda, generator=gen) < 0.8)[:, None] \
        .expand(B, F).contiguous()
    before = neighborhood_attention.launches
    got = neighborhood_attention(q, k, v, mask)
    again = neighborhood_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert neighborhood_attention.launches == before + 2
    assert torch.equal(got, again)
    want = neighborhood_attention_ref(q, k, v, mask)
    # f32: sum order; bf16: one bf16 ulp of the output (2^-7 relative)
    tol = (1e-5, 1e-5) if dtype == "float32" else (2 ** -6, 1e-5)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0],
                               atol=tol[1])
    assert not got[~mask[:, 0]].any()


@pytest.mark.cuda
def test_segment_sum_kernel_at_tgat_boundary_on_card(cuda):
    """K4 at TGAT's layer boundary at batch 4000: 132,000 instances of
    width 100 into a tier cap of 66,048 rows (factor 0.5), the masked
    instances (here 20,000) joining one rank at the end as the dedup puts
    them."""
    L, cap, D = 132_000, 66_048, 100
    seg, dhs = _segments(L, cap, D, seed=9, tail=20_000)
    seg, dhs = torch.from_numpy(seg).to(cuda), torch.from_numpy(dhs).to(cuda)
    before = sorted_segment_sum.launches
    got = sorted_segment_sum(dhs, seg, cap)
    again = sorted_segment_sum(dhs, seg, cap)
    torch.cuda.synchronize()
    assert sorted_segment_sum.launches == before + 2
    assert torch.equal(got, again)           # no atomics
    want = sorted_segment_sum_ref(dhs.double(), seg, cap)
    err = (got.double() - want).abs()
    assert (err.max() / want.abs().max()).item() <= 1e-5
    abs_sum = sorted_segment_sum_ref(dhs.abs().double(), seg, cap)
    assert (err / abs_sum.clamp_min(1e-300)).max().item() <= 1e-5
    assert not got[cap - 7:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("L,D", [(192_000, 100), (132_000, 200)],
                         ids=["graphsage", "gat"])
def test_segment_sum_kernel_at_static_boundaries_on_card(cuda, L, D):
    """K4 at the static models' layer boundaries at batch 4000 and the
    layer dedup's factor 0.95: GraphSAGE's 12,000 roots x 16 instances of
    width 100, and GAT's 12,000 x 11 of width 200 (its two heads' flat
    output), each into the 0.95 tier's cap."""
    from gnnflow_tpu_torch.train import tier_caps
    (cap,) = tier_caps([0.95], L)
    seg, dhs = _segments(L, cap, D, seed=L + D)
    seg, dhs = torch.from_numpy(seg).to(cuda), torch.from_numpy(dhs).to(cuda)
    before = sorted_segment_sum.launches
    got = sorted_segment_sum(dhs, seg, cap)
    again = sorted_segment_sum(dhs, seg, cap)
    torch.cuda.synchronize()
    assert sorted_segment_sum.launches == before + 2
    assert torch.equal(got, again)           # no atomics
    want = sorted_segment_sum_ref(dhs.double(), seg, cap)
    err = (got.double() - want).abs()
    assert (err.max() / want.abs().max()).item() <= 1e-5
    abs_sum = sorted_segment_sum_ref(dhs.abs().double(), seg, cap)
    assert (err / abs_sum.clamp_min(1e-300)).max().item() <= 1e-5
    assert not got[cap - 7:].any()
