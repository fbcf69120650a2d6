"""Parameters carried between the JAX package's pickles and the port's
modules, the checkpoint files, and the port's device policy."""

import glob
import os
import pickle
import re

import numpy as np
import pytest
import torch

import coulombgas_tpu as cg
from coulombgas_tpu_torch import config
from coulombgas_tpu_torch.io import checkpoint, convert
from coulombgas_tpu_torch.io.logging import ObservableLog, stderr_from_moments
from coulombgas_tpu_torch.models.ferminet import (
    FermiNet, FermiNetConfig, init_ferminet_params,
)
from coulombgas_tpu_torch.models.transformer import (
    Transformer, TransformerConfig, init_kv_cache, init_transformer_params,
)
from coulombgas_tpu_torch.sampling.autoregressive import make_autoregressive_sampler
from coulombgas_tpu_torch.wavefunction.fast_logp import make_logp_fast

from _torch_helpers import flow_pair, np_tree, orbitals, van_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N13 = glob.glob(os.path.join(ROOT, "data", "interacting", "n_13_*", "epoch_000100.pkl"))


def _trees_equal(a, b):
    fa, fb = convert.flatten_tree(a), convert.flatten_tree(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k])


def test_flatten_and_unflatten_are_inverse():
    tree = {"sp": [{"w": np.ones((2, 3)), "b": np.zeros(3)}, {"w": np.ones((3, 3)), "b": np.ones(3)}],
            "final": {"w": np.ones((3, 2)), "b": np.zeros(2)}, "x1hat": np.arange(4.0)}
    flat = convert.flatten_tree(tree)
    assert set(flat) == {"sp.0.w", "sp.0.b", "sp.1.w", "sp.1.b", "final.w", "final.b", "x1hat"}
    back = convert.unflatten_tree(flat)
    assert isinstance(back["sp"], list) and len(back["sp"]) == 2
    _trees_equal(tree, back)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_flow_roundtrip_keeps_names_and_values(depth):
    S = 2 if depth == 1 else 6
    _, params, flow = flow_pair(depth, S, 5, 4, 2)
    tree = np_tree(params)
    assert sorted(convert.flatten_tree(tree)) == sorted(flow.state_dict())
    back = convert.flow_to_numpy(flow)
    assert isinstance(back["tp"], list) and len(back["tp"]) == depth - 1
    _trees_equal(tree, back)


def test_van_roundtrip_keeps_names_and_values():
    _, params, van = van_pair(9, 2, 8, 2, 12, 2)
    tree = np_tree(params)
    assert sorted(convert.flatten_tree(tree)) == sorted(van.state_dict())
    assert "layers.1.attn.q.w" in van.state_dict() and "x1hat" in van.state_dict()
    _trees_equal(tree, convert.van_to_numpy(van))


def test_conversion_refuses_a_wrong_shape_or_name():
    _, params, _ = flow_pair(2, 6, 5, 4, 2)
    other = FermiNet(FermiNetConfig(2, 8, 5, 3.0), 2, torch.float64)
    with pytest.raises(ValueError, match="shape"):
        convert.flow_from_numpy(np_tree(params), other)
    deeper = FermiNet(FermiNetConfig(3, 6, 5, 3.0), 2, torch.float64)
    with pytest.raises(ValueError, match="names differ"):
        convert.flow_from_numpy(np_tree(params), deeper)


@pytest.mark.skipif(not N13, reason="the checked-in n = 13 checkpoint is missing")
def test_reference_checkpoint_loads_into_the_port():
    """An ``epoch_*.pkl`` written by main.py (f32 numpy pytrees)."""
    ckpt = convert.load_reference_checkpoint(N13[0])
    # the JAX key is dropped; main.py's optimizer state is carried over
    assert set(ckpt) == {"x", "params_van", "params_flow", "opt_state"}
    n, dim, L = 13, 2, float(np.sqrt(np.pi * 13))
    sp = orbitals(dim, 25)
    van = convert.van_from_numpy(
        ckpt["params_van"], Transformer(TransformerConfig(sp.shape[0], 2, 16, 4, 32), dim, torch.float64))
    flow = convert.flow_from_numpy(
        ckpt["params_flow"], FermiNet(FermiNetConfig(2, 16, 16, L), dim, torch.float64))
    np.testing.assert_array_equal(flow.sp[1].w.detach().numpy(),
                                  ckpt["params_flow"]["sp"][1]["w"].astype(np.float64))
    x = torch.from_numpy(ckpt["x"][:4].astype(np.float64))
    sampler, log_prob = make_autoregressive_sampler(sp, n, sp.shape[0])
    si = sampler(van, torch.Generator().manual_seed(0), 4)
    logp = make_logp_fast(sp, L)(x, flow, si)
    assert torch.isfinite(logp).all()
    with torch.no_grad():
        lp = log_prob(van, si)
    assert torch.isfinite(lp).all() and float(lp.max()) < 0
    # against the JAX package on the same file
    import jax
    import jax.numpy as jnp
    cfg_j = cg.TransformerConfig(sp.shape[0], 2, 16, 4, 32)
    _, log_prob_j = cg.make_autoregressive_sampler(cfg_j, sp, n, sp.shape[0])
    params_j = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), ckpt["params_van"])
    ref = jax.vmap(log_prob_j, (None, 0))(params_j, jnp.asarray(si.numpy().astype(np.int32)))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-10)


def test_checkpoint_files_hold_numpy_only(tmp_path):
    _, _, flow = flow_pair(2, 6, 5, 4, 2)
    data = {"x": torch.ones(2, 3), "params_flow": convert.flow_to_numpy(flow),
            "opt": {"state": {0: {"step": torch.tensor(3.0)}}, "param_groups": [{"lr": 1e-3, "params": [0]}]}}
    fname = checkpoint.ckpt_filename(7, str(tmp_path))
    assert fname.endswith("epoch_000007.pkl")
    assert checkpoint.pretrained_model_filename("a").endswith(os.path.join("a", "params_van.pkl"))
    checkpoint.save_data(data, fname)
    with open(fname, "rb") as f:
        raw = pickle.load(f)  # readable with numpy alone
    assert isinstance(raw["x"], np.ndarray) and raw["opt"]["param_groups"][0]["lr"] == 1e-3
    back = checkpoint.from_host(checkpoint.load_data(fname))
    assert isinstance(back["x"], torch.Tensor) and float(back["opt"]["state"][0]["step"]) == 3.0
    _trees_equal(raw["params_flow"], convert.flow_to_numpy(flow))


def test_observable_log_writes_the_reference_format(tmp_path, capsys):
    log = ObservableLog(str(tmp_path))
    log.write_train(3, *[0.5 * k for k in range(1, 11)], 0.4567)
    log.close()
    line = open(os.path.join(str(tmp_path), "data.txt")).read()
    assert line == ("     3" + "".join("  %.6f" % (0.5 * k) for k in range(1, 11)) + "  0.4567\n")
    assert "iter: 0003" in capsys.readouterr().out
    ObservableLog(str(tmp_path)).close()  # a fresh run moves the old log aside
    assert os.path.isfile(os.path.join(str(tmp_path), "data.txt.bak1"))
    assert stderr_from_moments(2.0, 5.0, 4) == 0.5 and stderr_from_moments(2.0, 3.9, 4) == 0.0


def test_device_policy():
    assert config.default_precision("cpu") == config.F64 and config.F64.is_x64
    assert config.F32.complex == torch.complex64 and not config.F32.is_x64
    assert config.complex_dtype(torch.float64) == torch.complex128
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert config.resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        # CUDA is the default, and asking for it where there is none raises
        with pytest.raises(RuntimeError, match="CUDA"):
            config.resolve_device(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            config.default_precision()


_FCFG, _VCFG = FermiNetConfig(1, 4, 4, 3.0), TransformerConfig(9, 1, 4, 2, 8)


@pytest.mark.parametrize("build,probe", [
    (lambda device=None: init_ferminet_params(
        _FCFG, 2, torch.Generator().manual_seed(0), torch.float64, device),
     lambda flow: flow.final.w),
    (lambda device=None: init_transformer_params(
        _VCFG, 2, torch.Generator().manual_seed(0), torch.float64, device),
     lambda van: van.x1hat),
    (lambda device=None: init_kv_cache(_VCFG, 2, 3, torch.float64, device),
     lambda caches: caches[0]),
], ids=["ferminet", "transformer", "kv_cache"])
def test_model_builders_default_to_cuda(build, probe):
    """The builders that choose a device choose CUDA unless told otherwise."""
    assert probe(build("cpu")).device.type == "cpu"
    if torch.cuda.is_available():
        assert probe(build()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            build()


def test_port_imports_neither_jax_nor_the_jax_package():
    files = glob.glob(os.path.join(ROOT, "coulombgas_tpu_torch", "**", "*.py"), recursive=True)
    files += [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "main_torch.py")]
    assert len(files) > 20
    pat = re.compile(r"^\s*(import|from)\s+(jax|optax|coulombgas_tpu)(\s|\.|$)", re.M)
    for f in files:
        assert not pat.search(open(f).read()), f


def test_kernel_sources_are_in_the_package():
    from coulombgas_tpu_torch.ops import _build

    for name in _build.KERNEL_SOURCES:
        src = open(_build.source_path(name)).read()
        assert "Replaces: coulombgas_tpu/ops/pallas_" in src and "Bound on this card" in src
        assert "torch/extension.h" not in src
    assert "use_fast_math" not in open(_build.__file__).read()
    assert os.path.isfile(os.path.join(_build.CSRC_DIR, "chol.cuh"))
    assert os.path.basename(_build.BUILD_DIR) == "build"
