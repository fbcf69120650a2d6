"""The sample step's draw without host reads, and the choice between a CUDA
graph and the eager step (CPU only; the graph itself is checked on the card
by ``chip_smoke.py``'s ``sample_graph`` phase).

The VAN's draw is ATen's own path for one sample of ``torch.multinomial``
written out; it must give the same indices and leave the generator where
``torch.multinomial`` leaves it, and ``torch.multinomial``'s checks of the
probabilities must still raise its errors.
"""

import re

import numpy as np
import pytest
import torch

from coulombgas_tpu_torch.models.ferminet import (
    FermiNetConfig, ferminet_apply, init_ferminet_params,
)
from coulombgas_tpu_torch.models.transformer import (
    TransformerConfig, init_kv_cache, init_transformer_params, transformer_decode_step,
)
from coulombgas_tpu_torch.ops import counters
from coulombgas_tpu_torch.physics.orbitals import sp_orbitals, twist_sort
from coulombgas_tpu_torch.sampling.autoregressive import (
    BAD_PROBS, ZERO_ROW, assert_drawable, draw, drawable, make_autoregressive_sampler,
)
from coulombgas_tpu_torch.sampling.mcmc import mcmc
from coulombgas_tpu_torch.train.train import (
    graph_key, make_sample_step, sample_graph, sample_graph_blocker,
)
from coulombgas_tpu_torch.wavefunction.fast_logp import make_logp_fast
from coulombgas_tpu_torch.wavefunction.logpsi import make_logp, make_logpsi

torch.set_num_threads(1)

N, DIM, EMAX, BATCH, STEPS, STDDEV = 5, 2, 4, 16, 3, 0.1
L = float(np.sqrt(np.pi * N))


@pytest.fixture(scope="module")
def models():
    sp, _ = sp_orbitals(DIM, EMAX)
    sp = twist_sort(sp, np.full(DIM, 0.25))[0][::-1].copy()
    M = sp.shape[0]
    gen = torch.Generator().manual_seed(3)
    van = init_transformer_params(TransformerConfig(M, 2, 16, 4, 32), DIM, gen,
                                  torch.float64, "cpu")
    with torch.no_grad():  # the default init is tiny: let the attention matter
        for p in van.parameters():
            p.mul_(8.0)
    flow = init_ferminet_params(FermiNetConfig(2, 8, 8, L, 0.1), DIM, gen, torch.float64, "cpu")
    x = L * torch.rand(BATCH, N, DIM, generator=gen, dtype=torch.float64)
    return {"sp": sp, "M": M, "van": van, "flow": flow, "x": x}


def multinomial_sampler(sp, n, M):
    """The sampler as it drew before: one ``torch.multinomial`` a particle."""

    @torch.no_grad()
    def sampler(van, generator, batch):
        p = van.x1hat
        table = torch.as_tensor(sp, dtype=p.dtype)
        kc, vc = init_kv_cache(van.cfg, batch, n, p.dtype, p.device)
        prev = torch.full((batch,), -1, dtype=torch.long)
        logits = p.expand(batch, M)
        m = torch.arange(M)
        samples = []
        for i in range(n):
            if i > 0:
                logits, kc, vc = transformer_decode_step(van, table[prev], i - 1, kc, vc)
            masked = torch.where((m > prev[:, None]) & (m <= M - n + i), logits,
                                 p.new_full((), -1e30))
            prev = torch.multinomial(torch.softmax(masked, dim=-1), 1, generator=generator)[:, 0]
            samples.append(prev)
        return torch.stack(samples, dim=1)

    return sampler


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,M", [(2048, 81), (7, 5), (33, 2), (1, 149)])
def test_draw_equals_multinomial_in_indices_and_generator_state(B, M, dtype):
    gen = torch.Generator().manual_seed(B * M)
    probs = torch.rand(B, M, generator=gen, dtype=torch.float64)
    probs[:, : M // 3] = 0.0  # masked columns, as the ordered occupations have
    probs[::3, M // 2:] = 0.0  # and rows with few states left
    probs[::3, M - 1] = 1.0
    probs = (probs / probs.sum(-1, keepdim=True)).to(dtype)
    g1, g2 = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    for _ in range(3):
        want = torch.multinomial(probs, 1, generator=g1)[:, 0]
        got = draw(probs, g2)
        assert torch.equal(got, want)
        assert torch.equal(g1.get_state(), g2.get_state())


def _faulty(kind):
    probs = torch.full((4, 6), 1.0 / 6, dtype=torch.float64)
    if kind == "nan":
        probs[2, 3] = float("nan")
    elif kind == "inf":
        probs[1, 0] = float("inf")
    elif kind == "negative":
        probs[3, 5] = -1e-3
    else:
        probs[0] = 0.0
    return probs


@pytest.mark.parametrize("kind", ["nan", "inf", "negative", "zero_row"])
def test_device_check_raises_multinomials_error(kind):
    good = torch.full((4, 6), 1.0 / 6, dtype=torch.float64)
    probs = _faulty(kind)
    with pytest.raises(RuntimeError) as want:
        torch.multinomial(probs, 1)
    message = ZERO_ROW if kind == "zero_row" else BAD_PROBS
    assert message in str(want.value)
    # the faulty draw among good ones, in every place
    for at in range(3):
        draws = [good, good, good]
        draws[at] = probs
        lows, highs = zip(*(torch.aminmax(p) for p in draws))
        sums = torch.stack([p.sum(dim=-1) for p in draws])
        finite, nonzero = drawable(torch.stack(lows), torch.stack(highs), sums)
        assert (bool(finite), bool(nonzero)) == ((True, False) if kind == "zero_row"
                                                 else (False, True))
        with pytest.raises(RuntimeError, match=re.escape(message)):
            assert_drawable(torch.stack(lows), torch.stack(highs), sums)
    lows, highs = zip(*(torch.aminmax(good) for _ in range(3)))
    assert_drawable(torch.stack(lows), torch.stack(highs), torch.stack([good.sum(-1)] * 3))


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_sampler_raises_on_a_van_with_a_bad_logit(models, bad):
    sampler, _ = make_autoregressive_sampler(models["sp"], N, models["M"])
    van = models["van"]
    with torch.no_grad():
        keep = van.x1hat[0].clone()
        van.x1hat[0] = bad
    try:
        with pytest.raises(RuntimeError, match="probability tensor contains"):
            sampler(van, torch.Generator().manual_seed(0), BATCH)
    finally:
        with torch.no_grad():
            van.x1hat[0] = keep


def test_sampler_and_sample_step_equal_the_multinomial_sampler(models):
    sp, M, van, flow, x0 = (models[k] for k in ("sp", "M", "van", "flow", "x"))
    sampler, _ = make_autoregressive_sampler(sp, N, M)
    reference = multinomial_sampler(sp, N, M)
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    for _ in range(2):
        assert torch.equal(sampler(van, g1, BATCH), reference(van, g2, BATCH))
        assert torch.equal(g1.get_state(), g2.get_state())

    logp = make_logp_fast(sp, L)
    step = make_sample_step(sampler, logp, STEPS, STDDEV, L, BATCH)

    def reference_step(x, generator):
        si = reference(van, generator, BATCH)
        x, accept = mcmc(lambda xx: logp(xx, flow, si), x, generator, STEPS, STDDEV)
        return si, x - L * torch.floor(x / L), accept

    x1 = x2 = x0
    for _ in range(3):
        si1, x1, a1 = step(van, flow, x1, g1)
        si2, x2, a2 = reference_step(x2, g2)
        assert torch.equal(si1, si2) and torch.equal(x1, x2) and torch.equal(a1, a2)
        assert torch.equal(g1.get_state(), g2.get_state())


def test_step_stays_eager_on_the_cpu_and_without_the_mark(models):
    sp, M, van, flow, x0 = (models[k] for k in ("sp", "M", "van", "flow", "x"))
    sampler, _ = make_autoregressive_sampler(sp, N, M)
    fast = make_logp_fast(sp, L)
    slow = make_logp(make_logpsi(ferminet_apply, sp, L))
    assert fast.graph_safe and not hasattr(slow, "graph_safe")
    cuda = torch.device("cuda")
    assert sample_graph_blocker(fast, cuda) == ""
    assert sample_graph_blocker(slow, cuda) == "the log-density is not marked graph-safe"
    assert sample_graph_blocker(fast, "cpu") == "walkers on the cpu"
    for logp in (fast, slow):
        step = make_sample_step(sampler, logp, 2, STDDEV, L, BATCH)
        before = dict(sample_graph)
        step(van, flow, x0, torch.Generator().manual_seed(1))
        assert sample_graph == dict(before, eager=before["eager"] + 1)


def test_graph_key_follows_the_parameters_storage(models):
    van, flow, x = models["van"], models["flow"], models["x"]
    gen = torch.Generator().manual_seed(0)
    key = graph_key(van, flow, x, gen)
    with torch.no_grad():  # what optimizers, SR updates and reverts do: in place
        for p in van.parameters():
            p.add_(0.0)
        flow.load_state_dict({k: v.clone() for k, v in flow.state_dict().items()})
    assert graph_key(van, flow, x.clone(), gen) == key
    assert graph_key(van, flow, x, torch.Generator().manual_seed(0)) != key
    assert graph_key(van, flow, x[:-1], gen) != key
    assert graph_key(van, flow, x.float(), gen) != key
    for module in (van, flow):
        p = next(module.parameters())
        keep = p.data
        p.data = p.data.clone()  # new storage: a capture would read the old one
        try:
            assert graph_key(van, flow, x, gen) != key
        finally:
            p.data = keep
    assert graph_key(van, flow, x, gen) == key


@pytest.mark.parametrize("symbol,counter", [
    ("_Z18cg_flow_jac_kernelILi16ELi16ELi2ELi2ELi1EEvPKfS1_PfS2_iif", "flow_u_jac"),
    ("_Z20cg_fused_logp_kernelPKfS0_S0_Pfiiif", "fused_logp"),
    ("_Z21cg_chol_logdet_kernelILi58ELi4EEvPKfPfiii", "chol_logdet"),
    ("_Z20cg_flow_large_kernelILi2ELi16ELi16ELi1ELb1EEvPKf13cg_lg_weightsPfS3_iiif",
     "flow_u_jac_large"),
    ("_Z22cg_flow_d2_rows_kernelILi2ELi16ELi16ELi1ELb1ELb0EEvPKfS1_PfS2_S2_iiif",
     "flow_u_jac_d2"),
    ("_Z22cg_flow_d2_rows_kernelILi2ELi32ELi32ELi2ELb0ELb1EEvPKfS1_PfS2_S2_iiif",
     "flow_u_jac_lap_d2"),
    ("void cg_flow_d2_rows_kernel<2, 16, 16, 1, true, false>(float const*, float const*)",
     "flow_u_jac_d2"),
    ("void cg_flow_d2_rows_kernel<2, 16, 16, 1, true, true>(float const*, float const*)",
     "flow_u_jac_lap_d2"),
    ("cg_fused_logp_kernel(float const*, float const*, float const*, float*, int)", "fused_logp"),
    ("_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctorIfEENS_6detail5ArrayIPcLi1EEEEEviT0_T1_", None),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x32x8_stage3_warpsize2x2x1_ffma_kernel", None),
    ("_Z19cg_flow_jac_kernel2v", None),
])
def test_kernel_counter_names_each_counted_kernel(symbol, counter):
    assert counters.kernel_counter(symbol) == counter


def test_replay_moves_the_launch_counters_as_its_capture_did(monkeypatch):
    """A capture counts nothing; a replay counts the kernel nodes of the
    graph (read from the graph itself), once each replay."""
    monkeypatch.setattr(counters, "launches", dict.fromkeys(counters.launches, 0))
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    counters.launched("flow_u_jac")
    capturing[0] = True
    counters.launched("flow_u_jac")  # recorded into a graph: not run
    counters.launched("flow_u_jac_d2")
    assert counters.launches == dict.fromkeys(counters.launches, 0) | {"flow_u_jac": 1}
    nodes = (["_Z22cg_flow_d2_rows_kernelILi2ELi16ELi16ELi1ELb1ELb0EEvPKf",
              "_Z20cg_fused_logp_kernelPKfS0_S0_Pfiiif", "ampere_sgemm_32x32_sliced1x4_nn"] * 51
             + ["_ZN2at6native18elementwise_kernelILi128ELi2EEEviT1_"] * 9)
    monkeypatch.setattr(counters, "graph_kernels", lambda graph: nodes)
    per_replay = counters.graph_launches(object())
    assert per_replay == dict.fromkeys(counters.launches, 0) | {"flow_u_jac_d2": 51,
                                                                "fused_logp": 51}
    counters.replayed(per_replay)
    counters.replayed(per_replay)
    assert counters.launches == dict.fromkeys(counters.launches, 0) | {
        "flow_u_jac": 1, "flow_u_jac_d2": 102, "fused_logp": 102}
    counters.reset()
    assert counters.launches == dict.fromkeys(counters.launches, 0)
