"""The port's update tripwire against the JAX package's, decision by decision:
the same observables go into both, and every return value (the snapshot to
revert to, or None), trust scale, event list and entropy-drift event must
agree — on the cases of tests/test_tripwire_v2.py (the real run traces,
the replay of the host64 divergence included) and the synthetic ones of
tests/test_sr_stability.py.
"""

import os

import numpy as np
import pytest

from coulombgas_tpu.train.tripwire import UpdateTripwire as JaxTripwire
from coulombgas_tpu_torch.train.tripwire import UpdateTripwire

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
RUN = ("n_{n}_dim_2_rs_{rs}_Theta_0.15_Emax_{emax}_twist_0.250_0.250_nlayers_2_modelsize_16_"
       "nheads_4_nhidden_32_depth_2_spsize_16_tpsize_16_Gmax_15_kappa_10_mctherm_10_mcsteps_50_"
       "mcstddev_0.10_hutchinson_damping_0.00100_maxnorm_0.00100_batch_{b}_ndevices_1_"
       "accsteps_{a}")
RS10 = os.path.join(DATA, "interacting", RUN.format(n=29, rs="10.0", emax=25, b=2048, a=4),
                    "data.txt")


def _rows(name):
    rs10 = np.loadtxt(RS10, ndmin=2)
    if name == "rs10":
        return rs10
    if name == "rs1":
        return np.loadtxt(os.path.join(DATA, "interacting", RUN.format(
            n=29, rs="1.0", emax=25, b=2048, a=4), "data.txt"), ndmin=2)
    if name == "n57":
        return np.loadtxt(os.path.join(DATA, "interacting", RUN.format(
            n=57, rs="1.0", emax=49, b=512, a=16), "data.txt"), ndmin=2)
    if name == "chol_leak":
        return np.concatenate([rs10, np.loadtxt(os.path.join(
            DATA, "failed_r5_chol_extension", "data_ext_3001_3600.txt"), ndmin=2)])
    if name == "host64_divergence":
        return np.concatenate([rs10[-600:], np.loadtxt(os.path.join(
            DATA, "failed_r5_host64_divergence", "trace_3001_3052.txt"), ndmin=2)])
    raise KeyError(name)


def _drive(tw, rows, signals=True):
    """Feed data.txt-format rows (iter F F_std ... S S_std accept) through
    ``tw``; returns what it decided at every epoch."""
    out = []
    for i, r in enumerate(rows):
        tw.snapshot(("state", i))
        kw = dict(accept=float(r[11]), S=float(r[9])) if signals else {}
        got = tw.check(float(r[1]), float(r[2]), bool(np.isfinite(r).all()), **kw)
        out.append((got, tw.trust_scale, tuple(tw.events), tuple(tw.drift_events),
                    tw.last_reason))
    return out


@pytest.mark.parametrize("trace", ["rs10", "rs1", "n57", "chol_leak", "host64_divergence"])
@pytest.mark.parametrize("signals", [True, False], ids=["with_signals", "F_only"])
def test_replays_of_the_run_traces_decide_alike(trace, signals):
    rows = _rows(trace)
    ours = _drive(UpdateTripwire(sigma=6.0), rows, signals)
    ref = _drive(JaxTripwire(sigma=6.0), rows, signals)
    assert ours == ref
    if trace == "chol_leak" and signals:  # the entropy-drift alarm fires in the leak
        assert ours[-1][3] and ours[-1][3][0] > 3000
    if trace == "host64_divergence" and signals:  # the first poisoned epoch (3028) trips
        fired = [int(r[0]) for r, o in zip(rows, ours) if o[0] is not None and r[0] >= 3028]
        assert fired and fired[0] <= 3029


def _synthetic(kind):
    """(F, F_stderr, finite, accept, S) sequences of the synthetic cases."""
    rng = np.random.default_rng(0)
    calm = [(-4.9 + 0.001 * np.sin(i), 0.0012, True, 0.41, 4.4) for i in range(30)]
    if kind == "sigma_explosion":
        return calm + [(-4.0, 98.0, True, 0.40, 4.4)]
    if kind == "accept_collapse":
        return calm + [(-4.9, 0.0012, True, 0.03, 4.4)]
    if kind == "nan_and_jump":
        seq = [(-1.0 + 0.01 * rng.normal(), 0.01, True, None, None) for _ in range(12)]
        return seq + [(5.0, 0.01, True, None, None), (float("nan"), float("nan"), False, None, None)]
    if kind == "burst":  # persistent instability: trust radius halves, then relaxes
        seq = []
        for k in range(6):
            seq += [(-1.0 + 0.01 * rng.normal(), 0.01, True, None, None) for _ in range(8)]
            seq += [(float("nan"), float("nan"), False, None, None)]
        return seq + [(-1.0 + 0.01 * rng.normal(), 0.01, True, None, None) for _ in range(200)]
    if kind == "runaway":
        seq = [(-1.0 + 0.005 * rng.normal(), 0.002, True, None, None) for _ in range(20)]
        return seq + [(-1.0 + 0.02 * k, 0.002, True, None, None) for k in range(30)]
    if kind == "plateau_noise":
        return [(-1.0 + 0.03 * rng.normal(), 0.003, True, None, None) for _ in range(200)]
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["sigma_explosion", "accept_collapse", "nan_and_jump",
                                  "burst", "runaway", "plateau_noise"])
@pytest.mark.parametrize("sigma", [6.0, 15.0, 0.0])
def test_synthetic_cases_decide_alike(kind, sigma):
    results = []
    for cls in (UpdateTripwire, JaxTripwire):
        tw, out = cls(sigma=sigma), []
        for i, (F, sig, fin, acc, S) in enumerate(_synthetic(kind)):
            tw.snapshot(i)
            got = tw.check(F, sig, fin, accept=acc, S=S)
            out.append((got, tw.trust_scale, tuple(tw.events), tw.last_reason))
        results.append((out, tw.disabled))
    assert results[0] == results[1]
    out, disabled = results[0]
    if sigma <= 0:  # any sigma <= 0 switches the tripwire off
        assert disabled and all(o[0] is None for o in out)
    elif kind in ("sigma_explosion", "accept_collapse"):
        assert out[-1][0] is not None
    elif kind == "burst":
        assert min(o[1] for o in out) < 1.0


def test_legacy_positional_api_reverts_to_the_previous_state():
    tw = UpdateTripwire(sigma=10.0)
    tw.snapshot("a")
    assert tw.check(-1.0, 0.01, True) is None
    tw.snapshot("b")
    assert tw.check(float("nan"), float("nan"), False) == "a"


def test_main_torch_reverts_a_non_finite_epoch(tmp_path, monkeypatch):
    """``main_torch.py --cpu --sr``: a non-finite epoch is reverted — the
    parameters, the walkers and the generator state that enter the next
    epoch are those of the best healthy epoch — and its row stays out of
    ``data.txt`` while ``sr_diag.txt`` records the event."""
    import torch

    import main_torch
    from coulombgas_tpu_torch.io.checkpoint import pretrained_model_filename, save_data
    from coulombgas_tpu_torch.io.convert import van_to_numpy
    from coulombgas_tpu_torch.models.transformer import (
        TransformerConfig, init_transformer_params,
    )
    from coulombgas_tpu_torch.physics.orbitals import sp_orbitals

    argv = ["--cpu", "--hutchinson", "--n", "5", "--Emax", "4", "--nlayers", "1",
            "--modelsize", "4", "--nheads", "2", "--nhidden", "6", "--spsize", "4",
            "--tpsize", "4", "--Gmax", "4", "--kappa", "5", "--batch", "6", "--mc_therm", "1",
            "--mc_steps", "2", "--acc_steps", "1", "--sr", "--sr_solver", "host64",
            "--epoch", "4", "--folder", str(tmp_path) + os.sep]
    args = main_torch.parse_args(argv)
    assert args.tripwire_sigma == 15.0  # on by default, as in main.py
    pre = main_torch.freefermion_path(args, np.array(args.twist))
    os.makedirs(pre)
    van = init_transformer_params(TransformerConfig(sp_orbitals(2, 4)[1].size, 1, 4, 2, 6), 2,
                                  torch.Generator().manual_seed(3), torch.float64, "cpu")
    save_data(van_to_numpy(van), pretrained_model_filename(pre))

    snaps = []

    class Recording(UpdateTripwire):
        def snapshot(self, state):
            snaps.append(state)
            super().snapshot(state)

    real_apply = main_torch.apply_step

    def apply_step(tr, acc, epoch, seconds, trust_scale=1.0):
        d, diag = real_apply(tr, acc, epoch, seconds, trust_scale)
        if epoch == 3:  # the observables of a broken step
            d = dict(d, F_mean=float("nan"))
            with torch.no_grad():
                next(tr.flow.parameters()).fill_(float("nan"))
        return d, diag

    monkeypatch.setattr(main_torch, "UpdateTripwire", Recording)
    monkeypatch.setattr(main_torch, "apply_step", apply_step)
    run = main_torch.train(args)
    assert run["reverted"] == [3] and [r["epoch"] for r in run["epochs"]] == [1, 2, 4]
    path = run["trainer"].path
    assert [int(r.split()[0]) for r in open(os.path.join(path, "data.txt"))] == [1, 2, 4]
    diag = open(os.path.join(path, "sr_diag.txt")).read().splitlines()
    assert [ln.split()[0] for ln in diag if not ln.startswith("#")] == ["1", "2", "4"]
    assert any("TRIPWIRE epoch 3: non-finite observables" in ln for ln in diag)
    # the state entering epoch 4 is the best healthy snapshot, restored in full
    F = {r["epoch"]: r["F"] for r in run["epochs"]}
    best = snaps[0 if F[1] <= F[2] else 1]
    van_s, flow_s, sr_s, x_s, gen_s = snaps[3]
    assert all(torch.equal(a, b) for a, b in zip(flow_s.values(), best[1].values()))
    assert all(torch.equal(a, b) for a, b in zip(van_s.values(), best[0].values()))
    assert sr_s == best[2] and torch.equal(x_s, best[3]) and torch.equal(gen_s, best[4])
    assert x_s.data_ptr() != best[3].data_ptr()  # a copy: the loop rebinds the walkers
    assert all(bool(torch.isfinite(p).all()) for p in run["trainer"].flow.parameters())
