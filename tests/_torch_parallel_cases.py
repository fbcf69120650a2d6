"""Shared set-up of the port's CPU data-parallel tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_parallel_groups.py``,
``tests/test_torch_parallel_straddle.py``).

The same global batch of walkers, occupations and Hutchinson probes (numpy
seed; the probes are the JAX engine's own draws) goes through one accumulate
and apply of ``main_torch.py``'s functions (``build_trainer``, the
accumulate, ``reduce_accumulators``, ``apply_step``) in spawned ranks of a
gloo group, each holding its contiguous share (``_torch_dist_worker``), in
one process holding all of it, and through the JAX package's accumulate and
apply jitted over a CPU mesh of as many devices
(``tests/test_train.py:_run_full_step``'s shardings).  Tolerances are those
of ``tests/test_train.py``'s mesh-size test: observables rtol 1e-9,
parameters rtol 1e-8 and atol 1e-10.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax

import _torch_dist_worker as dw
import main_torch
from coulombgas_tpu.optim import host_sr as jax_host_sr
from coulombgas_tpu.optim import sr as jax_sr
from coulombgas_tpu.parallel.mesh import batch_spec, make_mesh, replicated_spec
from coulombgas_tpu.train.train import (
    init_accumulators as jax_init_accumulators,
    make_accumulate_and_apply as jax_make_accumulate_and_apply,
)
from coulombgas_tpu_torch.io.checkpoint import save_data
from coulombgas_tpu_torch.io.convert import flatten_tree

from _torch_helpers import hutchinson_probe, np_tree, training_stacks

N, DIM, BATCH, EMAX = 4, 2, 16, 4
DAMPING = MAX_NORM = LR = 1e-3
OPTIMIZERS = {"adam": [], "plain": ["--sr"], "host64": ["--sr", "--sr_solver", "host64"]}
KEY = jax.random.PRNGKey(7)
RTOL_OBS, RTOL_P, ATOL_P = 1e-9, 1e-8, 1e-10


def argv(folder, opt, micro, batch=BATCH):
    return (["--cpu", "--hutchinson", "--n", str(N), "--dim", str(DIM), "--rs", "5.0",
             "--Emax", str(EMAX), "--nlayers", "1", "--modelsize", "8", "--nheads", "2",
             "--nhidden", "12", "--depth", "2", "--spsize", "6", "--tpsize", "5",
             "--Gmax", "5", "--kappa", "6", "--batch", str(batch), "--acc_steps", "1",
             "--folder", folder, "--tripwire_sigma", "0"]
            + OPTIMIZERS[opt] + (["--microbatch", str(micro)] if micro else []))


def layout(layouts, name):
    """(ranks, microbatch, global batch) of a layout given as (ranks,
    microbatch) at ``BATCH`` walkers or as all three."""
    world, micro, *batch = layouts[name]
    return world, micro, (batch[0] if batch else BATCH)


def _chunks(micro, batch=BATCH):
    """The JAX package's chunks of the global batch (one at least the batch
    is the whole-batch program)."""
    return 1 if micro is None or micro >= batch else batch // micro


def _stacks(batch):
    return training_stacks(n=N, dim=DIM, batch=batch, Emax=EMAX, rs=5.0, kappa=6, gmax=5)


def jax_steps(stacks, cases, layouts):
    """The JAX package's accumulate and apply over a mesh of as many CPU
    devices as the layout has ranks, for each (optimizer, layout) of
    ``cases`` (``stacks``: ``training_stacks`` by global batch); SR
    ``plain`` and ``host64`` share one accumulate."""
    from jax.flatten_util import ravel_pytree

    first = next(iter(stacks.values()))
    pv, pf = first["params_van"], first["params_flow"]
    sr_opt = jax_sr.hybrid_fisher_sr(first["classical_score_j"], first["quantum_score_j"],
                                     DAMPING, MAX_NORM)
    adam = optax.adam(LR)
    accs, applies, out = {}, {}, {}
    for opt, lay in cases:
        ndev, micro, batch = layout(layouts, lay)
        st = stacks[batch]
        si, x = jnp.asarray(st["si"]), jnp.asarray(st["x"])
        sr = opt != "adam"
        key = (sr, ndev, _chunks(micro, batch), batch)
        if key not in accs:
            mesh = make_mesh(jax.devices()[:ndev])
            bspec, rspec = batch_spec(mesh), replicated_spec(mesh)
            acc_fn, apply_fn = jax_make_accumulate_and_apply(
                st["loss_j"], None if sr else adam, 1, sr_opt if sr else None,
                microbatch=None if _chunks(micro, batch) == 1 else micro)
            applies.setdefault(sr, jax.jit(apply_fn))  # the apply reads no microbatch
            accs[key] = jax.jit(acc_fn, in_shardings=(rspec, rspec, bspec, bspec, None, rspec),
                                out_shardings=rspec)(
                pv, pf, si, x, KEY, jax_init_accumulators(pv, pf, sr, jnp.float64))
        acc = accs[key]
        if opt == "host64":
            uv, uf, d, _ = jax_host_sr.host_hybrid_apply(jax.device_get(acc), 1, DAMPING,
                                                         MAX_NORM)
            (fv, unravel_v), (ff, unravel_f) = ravel_pytree(pv), ravel_pytree(pf)
            out[opt, lay] = d, np_tree((unravel_v(fv + uv), unravel_f(ff + uf)))
            continue
        state = sr_opt.init(None) if sr else adam.init((pv, pf))
        new_van, new_flow, _, data = applies[sr](pv, pf, state, acc)
        d = {k: float(v) for k, v in data.items() if not k.startswith("diag_")}
        out[opt, lay] = d, np_tree((new_van, new_flow))
    return out


def parallel_runs(tmp, cases, layouts, jax_cases):
    """Every case in ranks (``runs["ranks"][case]``: one result per rank),
    in one process (``"one"``) and, for ``jax_cases``, in the JAX package
    (``"jax"``: observables and new parameter pytrees)."""
    stacks = {b: _stacks(b) for b in sorted({layout(layouts, lay)[2] for _, lay in cases})}
    first = next(iter(stacks.values()))  # the models do not depend on the batch
    trees = (np_tree(first["params_van"]), np_tree(first["params_flow"]))
    folder = str(tmp) + os.sep
    args = main_torch.parse_args(argv(folder, "adam", None))
    pre = main_torch.freefermion_path(args, np.array(args.twist))
    os.makedirs(pre)
    save_data(trees[0], os.path.join(pre, "params_van.pkl"))
    jobs, one = {}, {}
    for opt, lay in cases:
        world, micro, batch = layout(layouts, lay)
        x, si = stacks[batch]["x"], stacks[batch]["si"]
        args_ = argv(folder, opt, micro, batch)
        v = hutchinson_probe(KEY, x.shape, _chunks(micro, batch))
        job = jobs.setdefault((world, batch), {"trees": trees, "x": x, "si": si, "cases": []})
        job["cases"].append({"argv": args_, "v": v, "name": (opt, lay)})
        one[opt, lay] = dw.step(args_, trees, x, si, v, str(tmp / "one"))
    ranks = {}
    for (world, batch), job in jobs.items():
        for r, per_rank in enumerate(dw.run(world, job, tmp / ("w%d_b%d" % (world, batch)))):
            for c, res in zip(job["cases"], per_rank):
                ranks.setdefault(c["name"], [None] * world)[r] = res
    return {"one": one, "jax": jax_steps(stacks, jax_cases, layouts), "ranks": ranks}


def flat_params(res):
    return flatten_tree({"van": res["van"], "flow": res["flow"]})


def _assert_params(got, want, what):
    got, want = flatten_tree(got), flatten_tree(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL_P, atol=ATOL_P,
                                   err_msg="%s %s" % (what, k))


def _assert_observables(got, want, what):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL_OBS, err_msg="%s %s" % (what, k))


def check_one_process(runs, case):
    """Rank 0 ends where one process holding the whole batch ends, the
    reduced accumulators (Fisher moments included) equal its accumulators."""
    res, one = runs["ranks"][case][0], runs["one"][case]
    _assert_observables(res["d"], one["d"], "observable")
    for k in res["diag"]:
        np.testing.assert_allclose(res["diag"][k], one["diag"][k], rtol=1e-8, err_msg=k)
    _assert_params({"van": res["van"], "flow": res["flow"]},
                   {"van": one["van"], "flow": one["flow"]}, "parameter")
    flat, flat_one = flatten_tree(res["acc"]), flatten_tree(one["acc"])
    assert sorted(flat) == sorted(flat_one)
    for k in flat:
        np.testing.assert_allclose(flat[k], flat_one[k], rtol=1e-8, atol=1e-11, err_msg=k)


def check_jax_mesh(runs, case):
    res = runs["ranks"][case][0]
    d_jax, (van_jax, flow_jax) = runs["jax"][case]
    _assert_observables(res["d"], d_jax, "observable vs JAX")
    _assert_params({"van": res["van"], "flow": res["flow"]},
                   {"van": van_jax, "flow": flow_jax}, "parameter vs JAX")


def check_replicas(runs, case):
    """Every rank ends with rank 0's parameters, observables and SR
    diagnostics, bit for bit, and imported no JAX."""
    per_rank = runs["ranks"][case]
    first = flat_params(per_rank[0])
    for res in per_rank:
        assert res["modules"] == [], res["modules"]
        assert res["d"] == per_rank[0]["d"] and res["diag"] == per_rank[0]["diag"]
        for k, val in flat_params(res).items():
            np.testing.assert_array_equal(val, first[k], err_msg=k)
