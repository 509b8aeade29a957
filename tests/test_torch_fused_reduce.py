"""The one-launch reduction of the probe and spmv kernels, held on the CPU.

On the card the probe and spmv CTAs sum their (8,128) noise partials in the
kernel's own epilogue (``reduce_fused`` in ``csrc/noise_slots.cuh``): each
CTA takes a ticket on its chunk's counter, the chunk's last arriver sums
the chunk in CTA order, and the last chunk to finish sums the chunk sums.
What can be held here:

* a plain model of that ticket epilogue, with the CTAs arriving in any
  order, gives ``ns.reduce_partials`` bit for bit and leaves every counter
  at 0;
* the plain versions the card is held against still match the reference's
  Pallas kernels (interpret mode) at 1, 31, 33 and 64 CTAs, within the
  bound of f32 summation in another order;
* the sources: the two kernels no longer launch ``nacc_reduce``, the
  epilogue reads other CTAs' partials through L2 (``ld.global.cg``, not
  ``__ldg``) and resets its counters;
* the per-(device, stream) workspace: cached, grown, never shrunk, and
  never allocated on the CPU path.
"""
try:
    import hypothesis
    import hypothesis.strategies as st
except ModuleNotFoundError:   # property tests skip; the rest still runs
    from conftest import hypothesis_stub as hypothesis
    from conftest import strategies_stub as st

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.noise_probes.kernel import probe_pallas_rt
from repro.kernels.noisy_matmul.ops import (
    default_noise_operand as jax_noise_operand)
from repro.kernels.spmv_ell.kernel import spmv_ell_pallas_rt
from repro_torch.convert import to_torch
from repro_torch.kernels import noise_slots as ns
from repro_torch.kernels.flash_attention.kernel import flash_attention_rt
from repro_torch.kernels.noise_probes.kernel import probe_plain, probe_rt
from repro_torch.kernels.noisy_matmul.kernel import matmul_rt
from repro_torch.kernels.noisy_matmul.ref import default_noise_operand
from repro_torch.kernels.spmv_ell.kernel import (blocks_per_cta,
                                                 spmv_ell_plain, spmv_ell_rt)
from repro_torch.kernels.spmv_ell.ref import make_band_ell

CSRC = os.path.join(os.path.dirname(__file__), os.pardir, "src",
                    "repro_torch", "csrc")
CTA_COUNTS = (1, 31, 33, 64)
K = 3


def _ticket_epilogue(parts: torch.Tensor, arrival) -> tuple:
    """Plain model of ``reduce_fused``: the CTAs of ``arrival`` (a
    permutation of range(P)) write their partial and take their tickets in
    that order. Returns (nacc, counters after the launch, the CTAs that
    summed a chunk, the CTA that summed the chunk sums)."""
    P = parts.shape[0]
    C = ns.n_chunks(P)
    counters = [0] * (1 + C)
    chunk_sums = [None] * C
    chunk_finishers, final = [], None
    nacc = None

    def sum_in_order(blocks):
        acc = torch.zeros(ns.NOISE_SHAPE, dtype=torch.float32)
        for b in blocks:
            acc = acc + b
        return acc

    def last_to_arrive(i, n):
        ticket = counters[i]
        counters[i] += 1
        if ticket == n - 1:
            counters[i] = 0
            return True
        return False

    for cta in arrival:
        c = cta // ns.REDUCE_CHUNK
        p0 = c * ns.REDUCE_CHUNK
        n = min(P - p0, ns.REDUCE_CHUNK)
        if not last_to_arrive(1 + c, n):
            continue
        chunk_finishers.append(cta)
        chunk_sums[c] = sum_in_order(parts[p0:p0 + n])   # CTA order
        if C == 1:
            nacc = chunk_sums[0]
            continue
        if last_to_arrive(0, C):
            final = cta
            nacc = sum_in_order(chunk_sums)
    return nacc, counters, chunk_finishers, final


def _partials(P: int, seed: int) -> torch.Tensor:
    # signed values of mixed magnitude: the order of the additions shows
    rs = np.random.RandomState(seed)
    return torch.from_numpy((rs.standard_normal((P, *ns.NOISE_SHAPE))
                             * 10.0 ** rs.randint(-3, 4, (P, 1, 1)))
                            .astype(np.float32))


def _check_epilogue(P: int, arrival) -> None:
    parts = _partials(P, seed=P)
    nacc, counters, finishers, final = _ticket_epilogue(parts, arrival)
    assert torch.equal(nacc, ns.reduce_partials(parts))
    assert counters == [0] * (1 + ns.n_chunks(P))
    assert len(finishers) == ns.n_chunks(P)
    assert (final is None) == (ns.n_chunks(P) == 1)


@hypothesis.settings(max_examples=30, deadline=None)
@hypothesis.given(data=st.data())
def test_ticket_epilogue_in_any_arrival_order_is_reduce_partials(data):
    P = data.draw(st.integers(min_value=1, max_value=2100), label="P")
    arrival = data.draw(st.permutations(range(P)), label="arrival")
    _check_epilogue(P, arrival)


@pytest.mark.parametrize("P", [1, 31, 32, 33, 64, 1000, 1056])
def test_ticket_epilogue_with_the_last_cta_first(P):
    _check_epilogue(P, list(reversed(range(P))))


def test_arrival_order_would_change_the_bits():
    """The epilogue must sum in CTA order: the same partials summed in
    their arrival order give other bits, so the model's equality above is
    not a property of any order."""
    parts = _partials(64, seed=64)
    order = torch.randperm(64, generator=torch.Generator().manual_seed(0))
    assert not torch.equal(ns.reduce_partials(parts[order]),
                           ns.reduce_partials(parts))


# --- the plain versions against the reference, at small CTA counts --------

@functools.lru_cache(maxsize=None)
def _jax_rt(kernel, mode, n_steps=None):
    fn = {"probe": functools.partial(probe_pallas_rt, n_steps=n_steps),
          "spmv": functools.partial(spmv_ell_pallas_rt, br=128)}[kernel]
    return jax.jit(functools.partial(fn, mode=mode, interpret=True))


def _summation_rtol(n_cta: int, steps_per_cta: int, mode: str) -> float:
    """Both sides add non-negative terms, in other orders: each is within
    chain * 2^-24 of the exact sum, with chain the longest run of f32
    additions into one element (the reference's single accumulator: every
    step's patterns; the port's: a partial's patterns, its chunk, the chunk
    sums), plus a 128-term product per mxu pattern."""
    ref_chain = n_cta * steps_per_cta * K
    port_chain = steps_per_cta * K + ns.REDUCE_CHUNK + ns.n_chunks(n_cta)
    dot = 128 if mode == "mxu" else 0
    return (ref_chain + port_chain + 2 * dot) * 2.0 ** -24


@pytest.mark.parametrize("mode", ["fp", "vmem", "mxu"])
@pytest.mark.parametrize("n_cta", CTA_COUNTS)
def test_probe_plain_matches_reference_at_cta_counts(n_cta, mode):
    noise_np = np.asarray(jax_noise_operand())
    (noise,) = to_torch((noise_np,))
    got = probe_plain(noise, mode=mode, k_noise=K, n_steps=n_cta)
    want = _jax_rt("probe", mode, n_cta)(jnp.int32(K), jnp.asarray(noise_np))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0,
                               rtol=_summation_rtol(n_cta, 1, mode))


@pytest.mark.parametrize("mode", ["fp", "vmem"])
@pytest.mark.parametrize("n_cta", CTA_COUNTS)
def test_spmv_plain_matches_reference_at_cta_counts(n_cta, mode):
    n = 128 * n_cta                      # one 128-row block per CTA
    assert -(-(n // 128) // blocks_per_cta(n // 128)) == n_cta
    vals, cols = make_band_ell(n, 16, 0.5, seed=n_cta)
    x = np.random.RandomState(n_cta).standard_normal(n).astype(np.float32)
    y, nacc = spmv_ell_plain(*to_torch((vals, cols, x)), mode=mode,
                             k_noise=K)
    y_ref, nacc_ref = _jax_rt("spmv", mode)(
        jnp.int32(K), *(jnp.asarray(a) for a in (vals, cols, x)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(nacc.numpy(), np.asarray(nacc_ref), atol=0,
                               rtol=_summation_rtol(n_cta, 1, mode))


# --- the sources ------------------------------------------------------------

def _read(name):   # whitespace-normalised source
    with open(os.path.join(CSRC, name)) as f:
        return " ".join(f.read().split())


def _body(src: str, signature: str) -> str:
    """The brace-balanced body of the function whose definition starts with
    ``signature``."""
    start = src.index(signature)
    i = src.index("{", start)
    depth = 0
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[i:j + 1]
    raise AssertionError(f"unbalanced body after {signature!r}")


@pytest.mark.parametrize("source,kernels", [
    ("noise_probes.cu", {"probe_kernel"}),
    ("spmv_ell.cu", {"spmv_ring_kernel", "spmv_kernel"})])
def test_one_launch_kernels_reduce_in_their_epilogue(source, kernels):
    src = _read(source)
    assert "reduce_partials(" not in src and "nacc_reduce" not in src
    launcher = _body(src, "static cudaError_t launch_")
    launched = re.findall(r"(\w+)<MODE, SK><<<", launcher)
    # one launch on each path through the launcher, of a kernel that ends
    # in the fused reduction
    assert sorted(launched) == sorted(kernels)
    for name in kernels:
        body = _body(src, f"{name}(const float* __restrict__")
        assert re.search(r"reduce_fused<MODE>\(acc, partials, chunk_sums, "
                         r"counters, nacc, [\w.]+, gridDim\.x, tid\);", body)


def _ring_stages(L: int) -> int:
    """``ring_stages`` of ``spmv_ell.cu``, from the constants it uses."""
    src = _read("spmv_ell.cu")
    assert "#define SPMV_STAGES_MAX 3" in src
    assert "#define SPMV_RING_SMEM (REPRO_SMEM_MAX - 1024)" in src
    assert "const int per_stage = 2 * 128 * L * (int)sizeof(float) + 8;" in src
    fit = (232448 - 1024) // (2 * 128 * L * 4 + 8)
    return 0 if fit < 2 else min(fit, 3)


@pytest.mark.parametrize("L,stages", [(8, 3), (16, 3), (72, 3), (80, 2),
                                      (112, 2), (120, 0), (256, 0)])
def test_spmv_ring_stages_fit_a_block_of_the_h100(L, stages):
    """The ring takes rows up to L=112 in 2 or 3 stages within a block's
    232,448 bytes, its ticket's static shared memory included; wider rows
    take the register path."""
    assert _ring_stages(L) == stages
    if stages:
        assert stages * (2 * 128 * L * 4 + 8) + 1024 <= 232448


def test_epilogue_reads_partials_through_l2_and_resets_its_counters():
    slots = _read("noise_slots.cuh")
    epilogue = "".join(_body(slots, sig) for sig in (
        "__device__ __forceinline__ float4 ld_coherent(",
        "__device__ __forceinline__ void sum_in_order(",
        "__device__ __forceinline__ bool last_to_arrive(",
        "__device__ __forceinline__ void reduce_fused("))
    assert "ld_coherent(src" in epilogue
    assert 'asm volatile("ld.global.cg.v4.f32' in epilogue
    assert "__ldg(" not in epilogue and ".nc" not in epilogue
    last = _body(slots, "__device__ __forceinline__ bool last_to_arrive(")
    assert "*counter = 0u;" in last
    # release before the ticket, acquire after it
    assert last.index("fence_acq_rel_gpu();") < last.index("atomicAdd(") \
        < last.rindex("fence_acq_rel_gpu();")
    # the matmul and attention keep the two-launch reduction
    for source in ("noisy_matmul.cu", "flash_attention.cu"):
        assert "reduce_partials(partials, n_cta, scratch, nacc, st)" in \
            _read(source)


# --- the workspace ----------------------------------------------------------

@pytest.fixture()
def clean_workspaces():
    before = dict(ns.WORKSPACES)
    yield
    ns.WORKSPACES.clear()
    ns.WORKSPACES.update(before)


def test_workspace_is_cached_per_stream_and_grows_without_shrinking(
        clean_workspaces):
    cpu = torch.device("cpu")
    ws = ns.workspace(40, cpu, stream=0x1234)
    assert ws.partials.shape == (40, *ns.NOISE_SHAPE)
    assert ws.chunk_sums.shape == (2, *ns.NOISE_SHAPE)
    assert ws.counters.dtype == torch.int32
    assert ws.counters.tolist() == [0, 0, 0]
    assert ns.workspace(40, cpu, stream=0x1234) is ws
    same = ns.workspace(7, cpu, stream=0x1234)
    assert same is ws and same.partials.data_ptr() == ws.partials.data_ptr()
    other = ns.workspace(7, cpu, stream=0x5678)
    assert other is not ws and other.n_cta == 7
    grown = ns.workspace(1056, cpu, stream=0x1234)
    assert grown.n_cta == 1056 and grown.chunk_sums.shape[0] == 33
    assert grown.counters.tolist() == [0] * 34
    assert ns.workspace(40, cpu, stream=0x1234) is grown
    assert ns.workspace(7, cpu, stream=0x5678) is other


def test_card_buffers_share_the_workspace_and_return_a_fresh_nacc(
        clean_workspaces):
    cpu = torch.device("cpu")
    p1, s1, n1 = ns.card_buffers(100, cpu, 0x9)
    p2, s2, n2 = ns.card_buffers(64, cpu, 0x9)
    ws = ns.workspace(1, cpu, 0x9)
    assert p1 is p2 is ws.partials and s1 is s2 is ws.chunk_sums
    assert p1.shape[0] >= 100 and s1.shape[0] >= ns.n_chunks(100)
    assert n1.shape == ns.NOISE_SHAPE and n1.data_ptr() != n2.data_ptr()


def test_cpu_path_allocates_no_workspace(clean_workspaces):
    ns.WORKSPACES.clear()
    noise = default_noise_operand()
    probe_rt(2, noise, mode="vmem", n_steps=40)
    vals, cols = make_band_ell(256, 16, 0.5, seed=0)
    x = np.random.RandomState(0).standard_normal(256).astype(np.float32)
    spmv_ell_rt(2, *to_torch((vals, cols, x)), mode="fp")
    a = torch.ones(128, 128)
    matmul_rt(1, a, a, noise, mode="fp")
    q = torch.ones(1, 2, 64, 64)
    flash_attention_rt(1, q, q, q, noise, mode="fp")
    assert ns.WORKSPACES == {}


# --- on the card ------------------------------------------------------------

@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these kernels there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps", [1, 31, 33, 64, 1056])
def test_cuda_fused_probe_against_plain(card, n_steps):
    noise = default_noise_operand(card)
    for mode in ("fp", "vmem"):
        got = probe_rt(K, noise, mode=mode, n_steps=n_steps)
        want = probe_plain(noise, mode=mode, k_noise=K, n_steps=n_steps)
        assert torch.equal(got, want)
    torch.cuda.synchronize()
    assert all(int(ws.counters.abs().sum()) == 0
               for ws in ns.WORKSPACES.values())
