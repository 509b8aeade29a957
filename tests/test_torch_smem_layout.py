"""Shared-memory budgets and partial order of the port's wgmma kernels.

The CUDA kernels run only on the card, but two of their contracts can be
held here, on the CPU, before a chip ever sees them:

* every (kernel, head dim, dtype, noise mode) variant that the runtime-k
  library builds fits the H100's 232,448 bytes of opt-in shared memory per
  block. The budget comes from the wrapper's mirror of the kernel's layout
  (``smem_bytes``), the value every launch passes and the kernel refuses
  when it differs from its own; the sources must carry the constants the
  mirrors are built from;
* the plain versions, which the card is held against bitwise for the fp
  and vmem ``nacc``, reduce one (8,128) partial per CTA in the order the
  kernels write them: ``ti*nx + tj`` for the matmul, ``bh*nq + qi`` for
  attention. A partial order other than that one gives other bits.
"""
import os
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import noise_slots as ns
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.noisy_matmul import kernel as mm

LIMIT = 232448
CSRC = os.path.join(os.path.dirname(__file__), os.pardir, "src",
                    "repro_torch", "csrc")
KIB = 1024


def _variants():
    """(kernel, hd, dtype, mode) of every kernel instance the runtime-k
    library holds."""
    out = [("noisy_matmul", None, torch.float32, m) for m in ns.MODES]
    out += [("flash_attention", hd, dt, m) for hd in fa.HEAD_DIMS
            for dt in fa.DTYPE_IDS for m in ns.MODES]
    return out


@pytest.mark.parametrize(
    "kernel,hd,dtype,mode", _variants(),
    ids=lambda v: str(v).replace("torch.", ""))
def test_shared_memory_budget_fits_the_h100(kernel, hd, dtype, mode):
    if kernel == "noisy_matmul":
        got = mm.smem_bytes(mode)
    else:
        got = fa.smem_bytes(hd, mode)
    assert 48 * KIB < got <= LIMIT


def test_ring_depths_are_the_documented_ones():
    assert [mm.ring_depth(m) for m in ns.MODES] == [6, 6, 4, 6]
    assert fa.KV_DEPTH == 2
    # a third stage at hd 128 beside the noise operand would not fit
    assert fa.smem_bytes(128, "mxu") + 2 * 64 * 128 * 4 + 16 > LIMIT


def test_sources_carry_the_constants_the_mirrors_use():
    def read(name):   # whitespace-normalised source
        with open(os.path.join(CSRC, name)) as f:
            return " ".join(f.read().split())

    slots, hopper = read("noise_slots.cuh"), read("hopper.cuh")
    matmul, attention = read("noisy_matmul.cu"), read("flash_attention.cu")
    assert re.search(r"#define REPRO_NZ_STRIDE 132\b", slots)
    assert re.search(r"#define REPRO_SMEM_MAX 232448\b", hopper)
    assert ("mm_stages<MODE>() * MM_STAGE_BYTES + (MODE == MODE_MXU ? "
            "MM_NZ_BYTES : 0) + 2 * mm_stages<MODE>() * 8 + 1024") in matmul
    assert "return MODE == MODE_MXU ? 4 : 6;" in matmul
    assert re.search(r"#define MM_SLICE 32\b", matmul)
    assert re.search(r"#define FA_DEPTH 2\b", attention)
    assert ("fa_tile_bytes<HD>() * 2 * FA_DEPTH + (fa_staged_noise<MODE>() ? "
            "FA_NZ_BYTES : 0) + 1024 + 16 * FA_DEPTH + 1024") in attention
    # the partial each CTA writes
    assert "partials + ((size_t)ti * nx + tj) * REPRO_NACC" in matmul
    assert "partials + ((size_t)bh * nq + qi) * REPRO_NACC" in attention


def _source_ints(text, *names):
    return [int(re.search(rf"#define {n} (\d+)\b", text).group(1))
            for n in names]


@pytest.mark.parametrize("mode", ns.MODES)
def test_hd256_mirror_is_the_source_layout(mode):
    """``smem_bytes(256, mode)`` rebuilt from ``fa_kernel_h256``'s own
    constants: ``FA_DEPTH`` K and V^T stages of ``FA_H_SUB`` x 256 f32, the
    noise operand (128 x ``REPRO_NZ_STRIDE`` f32) in mxu and vmem, the S
    exchange (16 floats of each of 256 threads), two mbarriers a stage and
    the 1024-byte alignment slack; inside the budget in every mode."""
    with open(os.path.join(CSRC, "flash_attention.cu")) as f:
        attention = " ".join(f.read().split())
    with open(os.path.join(CSRC, "noise_slots.cuh")) as f:
        (stride,) = _source_ints(f.read(), "REPRO_NZ_STRIDE")
    sub, depth = _source_ints(attention, "FA_H_SUB", "FA_DEPTH")
    assert "#define FA_H_STAGE (FA_H_SUB * 256 * 4)" in attention
    assert "#define FA_H_XCH (2 * 128 * 16 * 4)" in attention
    assert ("FA_H_STAGE * 2 * FA_DEPTH + (fa_staged_noise<MODE>() ? "
            "FA_NZ_BYTES : 0) + FA_H_XCH + 16 * FA_DEPTH + 1024") in attention
    staged = mode in ("mxu", "vmem")
    want = (sub * 256 * 4 * 2 * depth + (128 * stride * 4 if staged else 0)
            + 2 * 128 * 16 * 4 + 16 * depth + 1024)
    assert fa.smem_bytes(256, mode) == want
    assert want == (216096 if staged else 148512) <= LIMIT


def _orders_differ(parts, order, want):
    """``want`` is the in-order reduction; the same partials reduced in
    ``order`` must give other bits, or the test could not tell."""
    assert torch.equal(ns.reduce_partials(parts), want)
    assert not torch.equal(ns.reduce_partials(parts[order]), want)


# vmem: each partial's noise depends on its step, so the order shows
@pytest.mark.parametrize("ni,nj", [(5, 8), (3, 12)])
def test_matmul_plain_reduces_partials_in_tile_order(ni, nj):
    mode, K = "vmem", 256
    rs = np.random.RandomState(0)
    a = torch.from_numpy(rs.standard_normal((ni * 128, K)).astype(np.float32))
    b = torch.from_numpy(rs.standard_normal((K, nj * 128)).astype(np.float32))
    noise = torch.from_numpy(rs.standard_normal((128, 128)).astype(np.float32))
    _, nacc = mm.matmul_plain(a, b, noise, mode=mode, k_noise=3)
    parts = ns.new_partials(ni * nj, a.device)
    for i in range(ni):
        for j in range(nj):
            for kk in range(K // 128):
                ns.emit_noise(mode, 3, parts[i * nj + j], noise,
                              src=a[i * 128:(i + 1) * 128,
                                    kk * 128:(kk + 1) * 128],
                              step=i * 131 + j * 17 + kk)
    # ti*nx + tj, not the column-major tj*ny + ti
    order = torch.tensor([i * nj + j for j in range(nj) for i in range(ni)])
    _orders_differ(parts, order, nacc)


@pytest.mark.parametrize("H,S", [(6, 320), (4, 448)])
def test_attention_plain_reduces_partials_in_cta_order(H, S):
    mode, B, KH, hd = "vmem", 1, 2, 64
    rs = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rs.standard_normal(s).astype(np.float32))
               for s in ((B, H, S, hd), (B, KH, S, hd), (B, KH, S, hd)))
    noise = torch.from_numpy(rs.standard_normal((128, 128)).astype(np.float32))
    _, nacc = fa.flash_attention_plain(q, k, v, noise, mode=mode, k_noise=2)
    nq = S // 64
    live = fa.live_blocks(nq, nq, 64, 64, True, 0)
    parts = ns.new_partials(B * H * nq, q.device)
    for bh in range(B * H):
        for qi in range(nq):
            for ki in range(nq):
                if live[qi, ki]:
                    ns.emit_noise(mode, 2, parts[bh * nq + qi], noise,
                                  step=bh * 131 + qi * 17 + ki)
    # bh*nq + qi, not qi*BH + bh
    order = torch.tensor([bh * nq + qi for qi in range(nq)
                          for bh in range(B * H)])
    _orders_differ(parts, order, nacc)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these kernels there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fp", "mxu", "vmem"])
def test_cuda_matmul_against_plain(card, mode):
    from repro_torch.kernels.flash_attention.ref import row_excess
    from repro_torch.kernels.noisy_matmul.ref import TF32_ROW_TOL

    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.RandomState(2)
    a, b = (torch.from_numpy(rs.standard_normal((512, 384)).astype(np.float32)
                             ).to(card),
            torch.from_numpy(rs.standard_normal((384, 256)).astype(np.float32)
                             ).to(card))
    noise = torch.from_numpy(rs.standard_normal((128, 128))
                             .astype(np.float32)).to(card)
    got = mm.matmul_rt(24, a, b, noise, mode=mode)
    want = mm.matmul_plain(a, b, noise, mode=mode, k_noise=24)
    # TF32 tensor cores against IEEE f32, row by row, and a kernel with
    # bf16 operands would fail the same limit
    assert row_excess(got[0], want[0], TF32_ROW_TOL) <= 1
    bf16 = mm.matmul_rt(24, a.bfloat16().float(), b.bfloat16().float(),
                        noise, mode=mode)
    assert row_excess(bf16[0], want[0], TF32_ROW_TOL) > 1
    if mode == "mxu":
        assert float((got[1] - want[1]).abs().max()) \
            <= 1e-2 * float(want[1].abs().max())
    else:
        assert torch.equal(got[1], want[1])
    static = mm.matmul(a, b, noise, mode=mode, k_noise=24)
    assert torch.equal(got[0], static[0]) and torch.equal(got[1], static[1])
