"""The port's kernels against the reference's Pallas kernels (interpret mode),
at small sizes on the CPU, where the port's wrappers take their plain
PyTorch versions: every kernel, mode and k in {0, 1, 5, 24}; runtime k
bitwise equal to static k; the K_MAX clamp; the vectorised noise oracles
equal to the reference's loop oracles. Inputs are made with numpy from a
seed and handed to both packages (``repro_torch.convert.to_torch``).

The CUDA kernels themselves run only on the card: the tests marked ``cuda``
skip without one (``python3 chip_smoke.py`` holds every kernel against its
plain version there)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import noise_slots as ref_ns
from repro.kernels.noise_probes.kernel import probe_pallas_rt
from repro.kernels.noise_probes.ref import probe_ref as jax_probe_ref
from repro.kernels.noisy_matmul.kernel import matmul_pallas_rt
from repro.kernels.noisy_matmul.ops import (
    default_noise_operand as jax_noise_operand)
from repro.kernels.spmv_ell import ref as jax_spmv_ref
from repro.kernels.spmv_ell.kernel import spmv_ell_pallas_rt
from repro_torch.convert import to_torch
from repro_torch.kernels import noise_slots as ns
from repro_torch.kernels.noise_probes.kernel import probe, probe_rt
from repro_torch.kernels.noise_probes.ref import probe_ref
from repro_torch.kernels.noisy_matmul.kernel import matmul, matmul_rt
from repro_torch.kernels.noisy_matmul.ref import (default_noise_operand,
                                                  fp_noise_ref, matmul_ref)
from repro_torch.kernels.spmv_ell.kernel import spmv_ell, spmv_ell_rt
from repro_torch.kernels.spmv_ell.ref import (fp_noise_ell_ref, make_band_ell,
                                              spmv_ell_ref, vmem_noise_ell_ref)

KS = (0, 1, 5, 24)
N_STEPS = 8
NACC_TOL = dict(rtol=1e-5, atol=1e-6)     # f32 adds in another order


@functools.lru_cache(maxsize=None)
def _jax_rt(kernel, mode):
    """One jitted reference executable per (kernel, mode), k a runtime int32."""
    fn = {"probe": functools.partial(probe_pallas_rt, n_steps=N_STEPS),
          "spmv": functools.partial(spmv_ell_pallas_rt, br=128),
          "matmul": functools.partial(matmul_pallas_rt, bm=128, bn=128,
                                      bk=128)}[kernel]
    return jax.jit(functools.partial(fn, mode=mode, interpret=True))


def _assert_equal(a, b):
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        assert torch.equal(x, y)


def _spmv_inputs(n=512, L=16, q=0.5, seed=1):
    vals, cols = make_band_ell(n, L, q, seed=seed)
    x = np.random.RandomState(seed + 1).standard_normal(n).astype(np.float32)
    return (vals, cols, x)


def _matmul_inputs(n=256):
    # a (the vmem noise source) non-negative: its k patterns sum without
    # cancellation, so the f32 order difference stays within NACC_TOL
    return (np.random.RandomState(0).random_sample((n, n)).astype(np.float32),
            np.random.RandomState(1).standard_normal((n, n)).astype(np.float32),
            np.asarray(jax_noise_operand()))


def test_noise_operand_and_band_matrix_match_the_reference():
    np.testing.assert_array_equal(default_noise_operand().numpy(),
                                  np.asarray(jax_noise_operand()))
    for args in ((512, 16, 0.0, 0), (300, 7, 0.5, 3), (256, 128, 1.0, 1)):
        got = make_band_ell(*args)
        want = jax_spmv_ref.make_band_ell(*args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
            assert g.dtype == np.asarray(w).dtype


@pytest.mark.parametrize("mode", ["fp", "mxu", "vmem"])
@pytest.mark.parametrize("k", KS)
def test_probe_matches_reference(mode, k):
    noise_np = np.asarray(jax_noise_operand())
    (noise,) = to_torch((noise_np,))
    got = probe_rt(k, noise, mode=mode, n_steps=N_STEPS)
    want = _jax_rt("probe", mode)(jnp.int32(k), jnp.asarray(noise_np))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **NACC_TOL)
    _assert_equal(got, probe(noise, mode=mode, k_noise=k, n_steps=N_STEPS))


@pytest.mark.parametrize("mode", ["fp", "vmem"])
@pytest.mark.parametrize("k", KS)
def test_spmv_matches_reference(mode, k):
    arrays = _spmv_inputs()
    vals, cols, x = to_torch(arrays)
    y, nacc = spmv_ell_rt(k, vals, cols, x, mode=mode)
    y_ref, nacc_ref = _jax_rt("spmv", mode)(
        jnp.int32(k), *(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(nacc.numpy(), np.asarray(nacc_ref), **NACC_TOL)
    _assert_equal((y, nacc), spmv_ell(vals, cols, x, mode=mode, k_noise=k))


@pytest.mark.parametrize("mode", ["fp", "mxu", "vmem"])
@pytest.mark.parametrize("k", KS)
def test_matmul_matches_reference(mode, k):
    arrays = _matmul_inputs()
    a, b, noise = to_torch(arrays)
    out, nacc = matmul_rt(k, a, b, noise, mode=mode)
    out_ref, nacc_ref = _jax_rt("matmul", mode)(
        jnp.int32(k), *(jnp.asarray(x) for x in arrays))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(nacc.numpy(), np.asarray(nacc_ref), **NACC_TOL)
    _assert_equal((out, nacc), matmul(a, b, noise, mode=mode, k_noise=k))


@pytest.mark.parametrize("mode", ["fp", "mxu", "vmem"])
def test_runtime_k_clamps_at_k_max(mode):
    noise = default_noise_operand()
    _assert_equal(probe_rt(ns.K_MAX + 7, noise, mode=mode, n_steps=2),
                  probe(noise, mode=mode, k_noise=ns.K_MAX, n_steps=2))
    vals, cols, x = to_torch(_spmv_inputs(n=256))
    if mode != "mxu":
        _assert_equal(spmv_ell_rt(ns.K_MAX + 3, vals, cols, x, mode=mode),
                      spmv_ell(vals, cols, x, mode=mode, k_noise=ns.K_MAX))
    assert ns.clip_k(-4) == 0 and ns.clip_k(ns.K_MAX + 1) == ns.K_MAX


@pytest.mark.parametrize("mode", ["fp", "mxu", "vmem"])
@pytest.mark.parametrize("k,n_steps", [(1, 4), (3, 16), (24, 8)])
def test_probe_oracle_matches_reference_oracle(mode, k, n_steps):
    noise_np = np.asarray(jax_noise_operand())
    (noise,) = to_torch((noise_np,))
    want = np.asarray(jax_probe_ref(jnp.asarray(noise_np), mode=mode,
                                    k_noise=k, n_steps=n_steps))
    np.testing.assert_allclose(
        probe_ref(noise, mode=mode, k_noise=k, n_steps=n_steps).numpy(), want,
        **NACC_TOL)
    np.testing.assert_allclose(
        probe(noise, mode=mode, k_noise=k, n_steps=n_steps).numpy(), want,
        **NACC_TOL)


@pytest.mark.parametrize("n,L,q,k", [(512, 16, 0.25, 4), (256, 128, 0.5, 3),
                                     (1024, 16, 1.0, 24), (64, 8, 0.0, 5),
                                     (512, 16, 0.0, 0)])
def test_vectorised_spmv_oracles_match_the_loop_oracles(n, L, q, k):
    vals_np, _ = make_band_ell(n, L, q, seed=3)
    (vals,) = to_torch((vals_np,))
    jvals = jnp.asarray(vals_np)
    np.testing.assert_allclose(
        fp_noise_ell_ref(vals, k, 128).numpy(),
        np.asarray(jax_spmv_ref.fp_noise_ell_ref(jvals, k, 128)), **NACC_TOL)
    np.testing.assert_allclose(
        vmem_noise_ell_ref(vals, k, 128).numpy(),
        np.asarray(jax_spmv_ref.vmem_noise_ell_ref(jvals, k, 128)), **NACC_TOL)


def test_spmv_oracles_hold_for_the_plain_kernel():
    vals, cols, x = to_torch(_spmv_inputs(n=1024, q=0.25))
    y, nacc = spmv_ell(vals, cols, x, mode="fp", k_noise=7)
    np.testing.assert_allclose(y.numpy(), spmv_ell_ref(vals, cols, x).numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(nacc.numpy(),
                               fp_noise_ell_ref(vals, 7).numpy(), **NACC_TOL)
    _, nacc = spmv_ell(vals, cols, x, mode="vmem", k_noise=7)
    np.testing.assert_allclose(nacc.numpy(),
                               vmem_noise_ell_ref(vals, 7).numpy(), **NACC_TOL)
    assert (nacc[:, 16:] == 0).all()


@pytest.mark.parametrize("mode", ["fp", "mxu", "vmem"])
def test_emit_noise_rt_is_the_clipped_static_emitter(mode):
    noise = default_noise_operand()
    for k, k_static in ((0, 0), (3, 3), (-2, 0), (ns.K_MAX + 1, ns.K_MAX)):
        got = torch.zeros(ns.NOISE_SHAPE)
        want = torch.zeros(ns.NOISE_SHAPE)
        ns.emit_noise_rt(mode, k, got, noise, src=noise, step=5)
        ns.emit_noise(mode, k_static, want, noise, src=noise, step=5)
        assert torch.equal(got, want)


def test_matmul_oracles():
    a, b, noise = to_torch(_matmul_inputs())
    out, nacc = matmul(a, b, noise, mode="fp", k_noise=3)
    np.testing.assert_allclose(out.numpy(), matmul_ref(a, b).numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(nacc.numpy(),
                               fp_noise_ref(noise, 3, 2 * 2 * 2).numpy(),
                               **NACC_TOL)


def test_fp_oracle_and_tf32_rounding():
    noise = default_noise_operand()
    np.testing.assert_allclose(
        ns.expected_fp_noise(noise, 3, 8).numpy(),
        np.asarray(ref_ns.expected_fp_noise(jax_noise_operand(), 3, 8)))
    t = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, -3.0],
                     dtype=torch.float32)
    # 10 mantissa bits kept, ties away from zero
    assert ns.round_tf32(t).tolist() == [1.0, 1.0 + 2 ** -10,
                                         1.0 + 2 ** -9, -3.0]


def test_wrappers_reject_what_the_kernels_do_not_take():
    noise = default_noise_operand()
    with pytest.raises(ValueError, match="noise mode"):
        probe_rt(1, noise, mode="hbm", n_steps=2)
    vals, cols, x = to_torch(_spmv_inputs(n=256))
    with pytest.raises(ValueError, match="no mxu"):
        spmv_ell_rt(1, vals, cols, x, mode="mxu")
    with pytest.raises(ValueError, match="tile"):
        matmul_rt(1, torch.ones(200, 128), torch.ones(128, 128), noise,
                  mode="fp")


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these kernels there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fp", "mxu", "vmem"])
def test_cuda_probe_against_plain(card, mode):
    from repro_torch.kernels.noise_probes.kernel import probe_plain

    noise = default_noise_operand(card)
    got = probe_rt(24, noise, mode=mode, n_steps=64)
    want = probe_plain(noise, mode=mode, k_noise=24, n_steps=64)
    if mode == "mxu":     # TF32 tensor cores against IEEE f32
        assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())
    else:
        assert torch.equal(got, want)
    _assert_equal(got, probe(noise, mode=mode, k_noise=24, n_steps=64))
