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
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gnnflow_tpu_torch.models.modules import masked_softmax
from gnnflow_tpu_torch.ops.attention_fused import (
    neighborhood_attention, neighborhood_attention_ref)
from gnnflow_tpu_torch.ops.gru_fused import (gru_memory_fused,
                                             gru_memory_fused_ref)


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
    mask[3] = False                      # one row fully masked
    return q, k, v, mask


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Run the plain versions on one CPU thread.  On a CPU host with
    AVX-512 and AMX, the first multi-threaded f32 matmul of a process that
    also runs JAX has returned one thread's 64-row block ~1e-4 off (3 of
    10 processes); on one thread the values are the same in every
    process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jref():
    """The JAX package's kernels (JAX is absent on the card's machine)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from gnnflow_tpu.models.modules import masked_softmax
    from gnnflow_tpu.ops.attention_pallas import neighborhood_attention
    from gnnflow_tpu.ops.gru_pallas import gru_memory_fused
    return SimpleNamespace(jnp=jnp, gru=gru_memory_fused,
                           attention=neighborhood_attention,
                           masked_softmax=masked_softmax)


# (compute dtype, mem/mail as pulled, tolerance); "bf16 pull" is the main
# path: memory and mails arrive rounded to bf16
GRU_CASES = {"f32": (None, np.float32, 2e-5),
             "bf16": ("bfloat16", np.float32, 1e-3),
             "bf16 pull": ("bfloat16", "bf16", 1e-3)}


@pytest.mark.parametrize("case", list(GRU_CASES))
@pytest.mark.parametrize("n", [512, 1000])   # whole and ragged Pallas tiles
def test_gru_ref_matches_pallas(jref, n, case):
    jnp = jref.jnp
    cd, state_dtype, tol = GRU_CASES[case]
    args = _gru_inputs(n)
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


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 5e-2)])
def test_attention_ref_matches_pallas(jref, dtype, tol):
    jnp = jref.jnp
    q, k, v, mask = _attention_inputs()
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jref.attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                                 jnp.asarray(v, jd), jnp.asarray(mask),
                                 True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    got = neighborhood_attention_ref(tq, tk, tv, torch.from_numpy(mask))
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)
    assert not got[3].any()              # fully masked row is exactly 0
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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRU_CASES))
def test_gru_kernel_matches_plain_on_card(cuda, case):
    cd, state_dtype, _ = GRU_CASES[case]
    args = [torch.from_numpy(a).to(cuda) for a in _gru_inputs(1000)]
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
