"""Resuming a ``main.py`` run's optimizer state in the port (f64, CPU).

A ``main.py`` Adam checkpoint pickles optax's state, ``(ScaleByAdamState(count,
mu, nu), EmptyState())`` over ``(params_van, params_flow)``, and a JAX RNG key
(``main.py:800-812``).  The port reads it without optax
(``io.checkpoint.load_data``), carries the moments and the step count into
``torch.optim.Adam`` (``io.convert.adam_state_from_reference``), and its next
step equals optax's next step on the same gradients.  ``main_torch.py``
resumes such a checkpoint, and a ``main.py`` SR checkpoint's state, with a
line each; the key is dropped with a line.
"""

import copy
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import main_torch
from coulombgas_tpu.io.checkpoint import save_data as jax_save_data
from coulombgas_tpu_torch.io.checkpoint import ForeignTuple, load_data
from coulombgas_tpu_torch.io.convert import (
    adam_state_from_reference, flatten_tree, flow_from_numpy, flow_to_numpy,
    load_reference_checkpoint, sr_state_from_reference, van_from_numpy, van_to_numpy,
)

from _torch_helpers import flow_pair, orbitals, van_pair

LR = 1e-3
N, DIM, EMAX = 4, 2, 4


def _grads(rng, params):
    return jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape)), params)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Two optax Adam steps on the carried-over models, the checkpoint
    main.py writes after them, and optax's third step."""
    M = orbitals(DIM, EMAX).shape[0]
    _, pf, flow = flow_pair(2, 6, 5, N, DIM, seed=0)
    _, pv, van = van_pair(M, 1, 8, 2, 12, DIM, seed=1)
    rng = np.random.default_rng(3)
    opt = optax.adam(LR)
    params, state = (pv, pf), opt.init((pv, pf))
    for _ in range(2):
        upd, state = opt.update(_grads(rng, params), state, params)
        params = optax.apply_updates(params, upd)
    path = str(tmp_path_factory.mktemp("jax") / "epoch_000002.pkl")
    jax_save_data({"key": jax.random.PRNGKey(0), "x": np.zeros((4, N, DIM)),
                   "params_van": params[0], "params_flow": params[1], "opt_state": state}, path)
    g3 = _grads(rng, params)
    upd, _ = opt.update(g3, state, params)
    nxt = optax.apply_updates(params, upd)
    return {"path": path, "van": van, "flow": flow, "g3": jax.tree.map(np.asarray, g3),
            "next": jax.tree.map(np.asarray, nxt), "mu": jax.tree.map(np.asarray, state[0].mu)}


def _adam(van, flow):
    return torch.optim.Adam([*van.parameters(), *flow.parameters()], lr=LR,
                            betas=(0.9, 0.999), eps=1e-8)


def _loaded(jax_run):
    ckpt = load_data(jax_run["path"])
    van, flow = copy.deepcopy(jax_run["van"]), copy.deepcopy(jax_run["flow"])
    van_from_numpy(ckpt["params_van"], van)
    flow_from_numpy(ckpt["params_flow"], flow)
    return ckpt, van, flow


def _step(van, flow, optimizer, grads):
    for module, tree in zip((van, flow), grads):
        flat = flatten_tree(tree)
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(np.array(flat[k]))
    optimizer.step()
    return flatten_tree({"van": van_to_numpy(van), "flow": flow_to_numpy(flow)})


def test_load_data_reads_optax_states_as_tuples(jax_run):
    adam, empty = load_data(jax_run["path"])["opt_state"]
    assert isinstance(adam, ForeignTuple) and len(adam) == 3 and len(empty) == 0
    assert adam.foreign.endswith("ScaleByAdamState") and empty.foreign.endswith("EmptyState")
    assert int(adam[0]) == 2


def test_load_data_stands_in_for_optax_classes_only(tmp_path):
    path = tmp_path / "array.pkl"
    path.write_bytes(pickle.dumps(jnp.arange(3.0)))
    got = load_data(str(path))
    assert not isinstance(got, ForeignTuple)
    np.testing.assert_array_equal(np.asarray(got), [0.0, 1.0, 2.0])
    path.write_bytes(b"cjax\nNoSuchClass\n)\x81.")
    with pytest.raises(AttributeError, match="NoSuchClass"):
        load_data(str(path))


def test_reference_checkpoint_keeps_the_optimizer_state_and_drops_the_key(jax_run):
    ref = load_reference_checkpoint(jax_run["path"])
    assert set(ref) == {"x", "params_van", "params_flow", "opt_state"}


def test_the_moments_carry_over_per_parameter(jax_run):
    ckpt, van, flow = _loaded(jax_run)
    optimizer = _adam(van, flow)
    assert adam_state_from_reference(ckpt["opt_state"], van, flow, optimizer) == 2
    mu = flatten_tree({"van": jax_run["mu"][0], "flow": jax_run["mu"][1]})
    named = [("van." + k, p) for k, p in van.named_parameters()] + [
        ("flow." + k, p) for k, p in flow.named_parameters()]
    for name, p in named:
        state = optimizer.state[p]
        assert float(state["step"]) == 2
        np.testing.assert_array_equal(state["exp_avg"].numpy(), mu[name])


def test_the_next_adam_step_is_optaxs(jax_run):
    ckpt, van, flow = _loaded(jax_run)
    optimizer = _adam(van, flow)
    adam_state_from_reference(ckpt["opt_state"], van, flow, optimizer)
    got = _step(van, flow, optimizer, jax_run["g3"])
    want = flatten_tree({"van": jax_run["next"][0], "flow": jax_run["next"][1]})
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-13, atol=1e-15, err_msg=k)
    # without the moments the step is another one
    _, van0, flow0 = _loaded(jax_run)
    fresh = _step(van0, flow0, _adam(van0, flow0), jax_run["g3"])
    assert any(np.abs(fresh[k] - want[k]).max() > 1e-6 for k in want)


def test_sr_state_of_main_py_maps_onto_sr_state():
    state = {"gnorm_van": np.float32(0.5), "scale_van": np.float32(0.25),
             "gnorm_flow": np.float32(2.0), "scale_flow": np.float32(1.0)}
    assert sr_state_from_reference(state) == {"gnorm_van": 0.5, "scale_van": 0.25,
                                              "gnorm_flow": 2.0, "scale_flow": 1.0}


TINY = ["--cpu", "--hutchinson", "--n", str(N), "--Emax", str(EMAX), "--nlayers", "1",
        "--modelsize", "8", "--nheads", "2", "--nhidden", "12", "--spsize", "6", "--tpsize", "5",
        "--Gmax", "4", "--kappa", "5", "--batch", "4", "--mc_therm", "1", "--mc_steps", "2",
        "--acc_steps", "1", "--epoch_finished", "2", "--epoch", "3", "--pre_epoch", "1",
        "--pre_batch", "8"]


@pytest.mark.parametrize("sr", [False, True], ids=["adam", "sr"])
def test_main_torch_resumes_a_main_py_checkpoint(tmp_path, capsys, sr):
    """The run directory holds a checkpoint as main.py writes it; the port
    resumes it with main.py's optimizer state and says what it dropped."""
    args = main_torch.parse_args(TINY + ["--folder", str(tmp_path) + os.sep]
                                 + (["--sr"] if sr else []))
    tr = main_torch.build_trainer(args)  # pretrains one epoch and writes its VAN
    pv, pf = van_to_numpy(tr.van), flow_to_numpy(tr.flow)
    if sr:
        state = {"gnorm_van": np.float64(0.5), "scale_van": np.float64(0.25),
                 "gnorm_flow": np.float64(2.0), "scale_flow": np.float64(1.0)}
    else:
        opt = optax.adam(LR)
        state = opt.init((pv, pf))
        _, state = opt.update(jax.tree.map(jnp.ones_like, (pv, pf)), state, (pv, pf))
    x = np.random.default_rng(0).uniform(0, tr.L, (args.batch, N, DIM))
    jax_save_data({"key": jax.random.PRNGKey(1), "x": x, "params_van": pv, "params_flow": pf,
                   "opt_state": state}, os.path.join(tr.path, "epoch_000002.pkl"))
    run = main_torch.train(args)
    out = capsys.readouterr().out
    assert "Load checkpoint:" in out and "JAX random key does not carry over" in out
    assert [r["epoch"] for r in run["epochs"]] == [3]
    if sr:
        assert "Carried over main.py's SR state" in out
    else:
        assert "Carried over main.py's Adam moments at step 1" in out
        steps = {float(s["step"]) for s in run["trainer"].optimizer.state.values()}
        assert steps == {2.0}  # the checkpoint's step, then this run's
