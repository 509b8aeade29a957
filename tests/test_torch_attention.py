"""The port's flash-attention kernel against the reference's Pallas kernel
(interpret mode) and its ``attention_ref`` oracle, at small sizes on the
CPU, where the port's wrappers take their plain PyTorch version: the five
shapes of the reference's own kernel test (MHA, GQA, MQA, non-causal,
sliding window; MQA at gemma-2b's head dim 256, causal and windowed), bf16,
every noise mode's ``nacc`` (at hd 64, and at hd 256 with 8 heads on one KV
head), runtime k bitwise equal to static k, the fp oracle under causal and
window block skip, a sequence below one block, the kernel each head dim's
region names, and the wrapper's refusals. Inputs are made with numpy from
a seed and handed to both packages.

Tolerances: outputs rtol 1e-4 / atol 1e-5 (both packages in IEEE f32; only
the order of summation differs); bf16 3e-2 (the reference's own bf16
tolerance); nacc rtol 1e-5 (the port adds into per-CTA partials, the
reference into one accumulator, so f32 additions run in another order).

The CUDA kernel runs only on the card: the test marked ``cuda`` skips here
(``python3 chip_smoke.py`` holds the kernel against its plain version
there)."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import (flash_attention_pallas,
                                                  flash_attention_pallas_rt)
from repro.kernels.flash_attention.ops import flash_attention as ref_fa
from repro.kernels.flash_attention.ref import attention_ref as jax_attn_ref
from repro.kernels.noisy_matmul.ops import (
    default_noise_operand as jax_noise_operand)
from repro_torch.convert import to_torch
from repro_torch.kernels import noise_slots as ns
from repro_torch.kernels.flash_attention.kernel import (flash_attention,
                                                        flash_attention_plain,
                                                        flash_attention_rt,
                                                        live_blocks)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     row_excess)
from repro_torch.kernels.noisy_matmul.ref import default_noise_operand

OUT_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
NACC_TOL = dict(rtol=1e-5, atol=1e-7)


def _qkv(B, H, KH, Sq, Sk, hd, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((B, H, Sq, hd)).astype(np.float32),
            rs.standard_normal((B, KH, Sk, hd)).astype(np.float32),
            rs.standard_normal((B, KH, Sk, hd)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_rt(mode, causal, window, bq, bk):
    """One jitted reference executable per setting, k a runtime int32."""
    return jax.jit(functools.partial(
        flash_attention_pallas_rt, causal=causal, window=window, bq=bq,
        bk=bk, mode=mode, interpret=True))


# the shapes of tests/test_kernels.py::test_flash_attention_sweep
@pytest.mark.parametrize("H,KH,Sq,Sk,hd,causal,window", [
    (4, 4, 256, 256, 64, True, 0),
    (8, 2, 256, 256, 64, True, 0),      # GQA
    (4, 1, 128, 128, 128, True, 0),     # MQA
    (4, 4, 128, 128, 64, False, 0),     # bidirectional (encoder)
    (4, 2, 256, 256, 64, True, 64),     # sliding window
    (8, 1, 256, 256, 256, True, 0),     # MQA at gemma-2b's head dim
    (8, 1, 256, 256, 256, True, 64),    # ... and a sliding window
], ids=["mha", "gqa", "mqa", "noncausal", "window64", "mqa-hd256",
        "mqa-hd256-window64"])
def test_attention_matches_reference_and_oracle(H, KH, Sq, Sk, hd, causal,
                                                window):
    arrays = _qkv(2, H, KH, Sq, Sk, hd)
    q, k, v = to_torch(arrays)
    out, nacc = flash_attention(q, k, v, causal=causal, window=window,
                                bq=128, bk=128)
    want, _ = ref_fa(*(jnp.asarray(a) for a in arrays), causal=causal,
                     window=window, bq=128, bk=128, backend="interpret")
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **OUT_TOL)
    np.testing.assert_allclose(
        out.numpy(), attention_ref(q, k, v, causal=causal,
                                   window=window).numpy(), **OUT_TOL)
    np.testing.assert_allclose(
        attention_ref(q, k, v, causal=causal, window=window).numpy(),
        np.asarray(jax_attn_ref(*(jnp.asarray(a) for a in arrays),
                                causal=causal, window=window)), **OUT_TOL)
    assert not nacc.any()


def test_attention_bf16():
    arrays = _qkv(1, 4, 4, 128, 128, 64, seed=1)
    q, k, v = (t.to(torch.bfloat16) for t in to_torch(arrays))
    out, _ = flash_attention(q, k, v, bq=64, bk=64)
    assert out.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
    want, _ = ref_fa(jq, jk, jv, bq=64, bk=64, backend="interpret")
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)
    np.testing.assert_allclose(out.float().numpy(),
                               attention_ref(q, k, v).float().numpy(),
                               **BF16_TOL)


@pytest.mark.parametrize("mode", ["fp", "mxu", "vmem"])
@pytest.mark.parametrize("kn", [0, 1, 4])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64)],
                         ids=["causal", "window64"])
def test_nacc_matches_reference(mode, kn, causal, window):
    arrays = _qkv(1, 4, 2, 256, 256, 64, seed=2)
    noise_np = np.asarray(jax_noise_operand())
    q, k, v, noise = to_torch((*arrays, noise_np))
    out, nacc = flash_attention_rt(kn, q, k, v, noise, causal=causal,
                                   window=window, bq=64, bk=64, mode=mode)
    want_out, want = _jax_rt(mode, causal, window, 64, 64)(
        jnp.int32(kn), *(jnp.asarray(a) for a in (*arrays, noise_np)))
    np.testing.assert_allclose(nacc.numpy(), np.asarray(want), **NACC_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **OUT_TOL)


@pytest.mark.parametrize("mode", ["fp", "mxu", "vmem"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64)],
                         ids=["causal", "window64"])
def test_hd256_mqa_matches_reference(mode, causal, window):
    """gemma-2b's attention shape at a small size (8 heads on 1 KV head,
    hd 256, seq 256): outputs and nacc against the reference's runtime-k
    kernel in interpret mode, 64-row blocks as the CUDA kernel takes them."""
    arrays = _qkv(1, 8, 1, 256, 256, 256, seed=7)
    noise_np = np.asarray(jax_noise_operand())
    q, k, v, noise = to_torch((*arrays, noise_np))
    out, nacc = flash_attention_rt(3, q, k, v, noise, causal=causal,
                                   window=window, bq=64, bk=64, mode=mode)
    want_out, want = _jax_rt(mode, causal, window, 64, 64)(
        jnp.int32(3), *(jnp.asarray(a) for a in (*arrays, noise_np)))
    np.testing.assert_allclose(nacc.numpy(), np.asarray(want), **NACC_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **OUT_TOL)


@pytest.mark.parametrize("hd,kernel", [(64, "fa_kernel_wgmma"),
                                       (128, "fa_kernel_wgmma"),
                                       (256, "fa_kernel_h256")])
def test_attention_region_names_its_kernels(hd, kernel):
    """The static audit's SASS census looks for the functions the region
    names: the kernel that holds the noise slot at this head dim, and the
    prep and the nacc reduction that every call launches beside it."""
    from repro_torch.kernels.region import _attention_spec

    spec = _attention_spec(torch.device("cpu"), heads=8, kv_heads=1, seq=64,
                           head_dim=hd)
    assert spec.kernels == ((kernel, ""),)
    assert spec.aux == (("fa_prep", ""), ("nacc_reduce", ""))
    assert spec.defines == (("REPRO_STATIC_HD", hd), ("REPRO_STATIC_BF16", 0))
    with open(os.path.join(os.path.dirname(__file__), os.pardir, "src",
                           "repro_torch", "csrc", "flash_attention.cu")) as f:
        source = f.read()
    assert f"\n{kernel}(const __grid_constant__ CUtensorMap tk" in source
    assert f"{kernel}<T, {'HD, ' if hd != 256 else ''}MODE, SK><<<" in source
    assert source.count("fa_prep<T, HD><<<") == 2


@pytest.mark.parametrize("mode", ["fp", "mxu", "vmem"])
def test_runtime_k_is_static_k_bitwise(mode):
    q, k, v = to_torch(_qkv(1, 4, 2, 128, 128, 64, seed=3))
    for kn, k_static in ((5, 5), (ns.K_MAX + 7, ns.K_MAX)):
        got = flash_attention_rt(kn, q, k, v, bq=64, bk=64, mode=mode)
        want = flash_attention(q, k, v, bq=64, bk=64, mode=mode,
                               k_noise=k_static)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("causal,window,live", [
    (True, 0, 10), (True, 64, 7), (False, 64, 13), (False, 0, 16)],
    ids=["causal", "causal-window64", "window64", "full"])
def test_fp_oracle_counts_live_blocks(causal, window, live):
    """fp nacc = k * (live blocks) * noise[0:8]: skipped blocks add
    nothing (4x4 blocks of 64 at seq 256, per (b, h))."""
    B, H = 2, 2
    q, k, v = to_torch(_qkv(B, H, 1, 256, 256, 64, seed=4))
    assert int(live_blocks(4, 4, 64, 64, causal, window).sum()) == live
    noise = default_noise_operand()
    _, nacc = flash_attention(q, k, v, noise, causal=causal, window=window,
                              bq=64, bk=64, mode="fp", k_noise=3)
    np.testing.assert_allclose(
        nacc.numpy(), ns.expected_fp_noise(noise, 3, B * H * live).numpy(),
        **NACC_TOL)


@pytest.mark.parametrize("mode", ["none", "fp", "vmem"])
def test_sequence_below_one_block(mode):
    """seq 24 with bq = bk = 64: the blocks shrink to 24 rows."""
    arrays = _qkv(1, 2, 2, 24, 24, 64, seed=5)
    noise_np = np.asarray(jax_noise_operand())
    q, k, v, noise = to_torch((*arrays, noise_np))
    out, nacc = flash_attention(q, k, v, noise, bq=64, bk=64, mode=mode,
                                k_noise=3)
    want_out, want = flash_attention_pallas(
        *(jnp.asarray(a) for a in (*arrays, noise_np)), bq=64, bk=64,
        mode=mode, k_noise=3, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **OUT_TOL)
    np.testing.assert_allclose(nacc.numpy(), np.asarray(want), **NACC_TOL)


@pytest.mark.parametrize("H,KH,Sq,bq", [(6, 4, 128, 64), (4, 2, 96, 64)],
                         ids=["heads-not-multiple", "seq-not-tiling"])
def test_wrapper_rejects_what_the_reference_rejects(H, KH, Sq, bq):
    arrays = _qkv(1, H, KH, Sq, Sq, 64)
    with pytest.raises(AssertionError) as ref_err:
        flash_attention_pallas(*(jnp.asarray(a) for a in arrays),
                               jax_noise_operand(), bq=bq, bk=bq,
                               interpret=True)
    with pytest.raises(ValueError) as err:
        flash_attention(*to_torch(arrays), bq=bq, bk=bq)
    assert str(ref_err.value) in str(err.value)


def test_wrapper_rejects_unknown_modes():
    q, k, v = to_torch(_qkv(1, 2, 2, 64, 64, 64))
    with pytest.raises(ValueError, match="noise mode"):
        flash_attention_rt(1, q, k, v, mode="hbm")


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this kernel there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fp", "mxu", "vmem"])
@pytest.mark.parametrize("B,H,KH,S,hd,dtype", [
    (2, 8, 2, 512, 128, torch.float32),
    (2, 8, 2, 512, 256, torch.float32),
    (2, 8, 2, 512, 256, torch.bfloat16),
    (1, 8, 1, 1024, 256, torch.float32),    # gemma-2b's MQA widths
], ids=["hd128-f32", "hd256-f32", "hd256-bf16", "gemma-mqa-hd256-f32"])
def test_cuda_attention_against_plain(card, mode, B, H, KH, S, hd, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (t.to(dtype) for t in
               to_torch(_qkv(B, H, KH, S, S, hd), card))
    got = flash_attention_rt(24, q, k, v, mode=mode)
    noise = default_noise_operand(card)
    want = flash_attention_plain(q, k, v, noise, mode=mode, k_noise=24)
    # TF32 tensor cores against IEEE f32, row by row (ref.TF32_ROW_TOL)
    assert row_excess(got[0], want[0]) <= 1
    if dtype == torch.float32:     # and a bf16-operand kernel would fail it
        bf16_operands = flash_attention_rt(
            24, *(t.bfloat16().float() for t in (q, k, v)), mode=mode)
        assert row_excess(bf16_operands[0], want[0]) > 1
    if mode == "mxu":
        assert float((got[1] - want[1]).abs().max()) \
            <= 1e-2 * float(want[1].abs().max())
    else:
        assert torch.equal(got[1], want[1])
    static = flash_attention(q, k, v, mode=mode, k_noise=24)
    assert torch.equal(got[0], static[0]) and torch.equal(got[1], static[1])


def test_row_excess_holds_each_row_to_its_own_size():
    """Causal row 0 is one V row (large); later rows average many (small).
    An error of 3e-3 of a late row's size fails the per-row check, though
    it lies far inside 1e-2 of the whole output's largest value."""
    q, k, v = to_torch(_qkv(1, 2, 2, 256, 256, 64, seed=6))
    want = attention_ref(q, k, v)
    row = want[0, 0, -1]
    for frac, ok in ((1e-3, True), (3e-3, False)):
        got = want.clone()
        got[0, 0, -1] += frac * row.abs().max()
        assert (row_excess(got, want) <= 1) is ok
        assert float((got - want).abs().max()) < 1e-2 * float(want.abs().max())
