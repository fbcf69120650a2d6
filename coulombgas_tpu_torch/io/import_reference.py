"""Import checkpoints produced by the reference (fermiflow/CoulombGas).

The port's copy of ``coulombgas_tpu/io/import_reference.py``, with no JAX:
the reference pickles haiku parameter dicts (src/checkpoint.py:1-17) with
module-path keys, and old ``jax.Array`` leaves, which ``_CompatUnpickler``
rebuilds as numpy arrays; this maps them onto the JAX package's numpy
pytrees, the layout ``io/convert.py:van_from_numpy`` / ``flow_from_numpy``
load into the port's modules (``load_reference_into`` does both steps), so
reference-trained models can seed parity checks and production runs.

Naming schemes (verified against hk.transform(...).init of the reference
modules, src/autoregressive.py:75-95 and src/flow.py:5-55):

  VAN (Transformer):
    transformer/embedding_mlp              -> params["embed"]
    transformer/layer{i}_attn/{query,key,value,linear}
                                           -> params["layers"][i]["attn"][q,k,v,o]
    transformer/layer{i}_mlp/{linear,linear_1}
                                           -> params["layers"][i]["mlp"][fc1,fc2]
    transformer/output_mlp                 -> params["out"]
    transformer : x1hat                    -> params["x1hat"]

  Flow (FermiNet) — haiku numbers the __init__-constructed linears in
  construction order (splayers first, then tplayers), under the "~" scope;
  the final projection is created in __call__:
    fermi_net/~/linear[_i]   (i < depth)        -> params["sp"][i]
    fermi_net/~/linear_{depth+j} (j < depth-1)  -> params["tp"][j]
    fermi_net/linear                            -> params["final"]

Checkpoint payloads (reference main.py:376-384): params are saved with the
device axis stripped; walkers x are (num_devices, batch_per_device, n, dim)
and PRNG keys (num_devices, 2) — flattened / reduced here to the global-batch
conventions of this framework.
"""

from __future__ import annotations

import pickle

import numpy as np

__all__ = [
    "convert_reference_van",
    "convert_reference_flow",
    "load_reference_checkpoint",
    "load_reference_into",
]


def _reconstruct_array_compat(fun, args, arr_state, aval_state):
    """Rebuild a pickled jax.Array of any JAX version as a numpy array.

    Old JAX pickles call ``jax._src.array._reconstruct_array(fun, args,
    arr_state, aval_state)`` whose aval payload (e.g. ``named_shape``) is not
    forward-compatible; the numpy half (fun, args, arr_state) is stable, and
    numpy is all the importer needs.
    """
    np_value = fun(*args)
    np_value.__setstate__(arr_state)
    return np_value


class _CompatUnpickler(pickle.Unpickler):
    """Reads a reference pickle with no JAX installed: a pickled
    ``jax.Array`` is rebuilt from its numpy half."""

    def find_class(self, module, name):
        if name == "_reconstruct_array" and module.startswith("jax"):
            return _reconstruct_array_compat
        return super().find_class(module, name)


def load_data(filename: str):
    """Pickle load tolerant of reference checkpoints from older JAX versions."""
    with open(filename, "rb") as f:
        return _CompatUnpickler(f).load()


def _linear(entry, dtype):
    return {"w": np.asarray(entry["w"], dtype), "b": np.asarray(entry["b"], dtype)}


def convert_reference_van(hk_params, num_layers: int, dtype=np.float32):
    """haiku Transformer params -> models.transformer pytree."""
    p = hk_params
    params = {
        "embed": _linear(p["transformer/embedding_mlp"], dtype),
        "layers": [],
        "out": _linear(p["transformer/output_mlp"], dtype),
        "x1hat": np.asarray(p["transformer"]["x1hat"], dtype),
    }
    for i in range(num_layers):
        attn = f"transformer/layer{i}_attn"
        mlp = f"transformer/layer{i}_mlp"
        params["layers"].append(
            {
                "attn": {
                    "q": _linear(p[f"{attn}/query"], dtype),
                    "k": _linear(p[f"{attn}/key"], dtype),
                    "v": _linear(p[f"{attn}/value"], dtype),
                    "o": _linear(p[f"{attn}/linear"], dtype),
                },
                "mlp": {
                    "fc1": _linear(p[f"{mlp}/linear"], dtype),
                    "fc2": _linear(p[f"{mlp}/linear_1"], dtype),
                },
            }
        )
    return params


def convert_reference_flow(hk_params, depth: int, dtype=np.float32):
    """haiku FermiNet params -> models.ferminet pytree."""
    p = hk_params

    def seq(i):
        return "fermi_net/~/linear" + ("" if i == 0 else f"_{i}")

    return {
        "sp": [_linear(p[seq(i)], dtype) for i in range(depth)],
        "tp": [_linear(p[seq(depth + j)], dtype) for j in range(depth - 1)],
        "final": _linear(p["fermi_net/linear"], dtype),
    }


def load_reference_checkpoint(filename: str, num_layers: int = 2, depth: int = 2,
                              dtype=np.float32):
    """Load a reference .pkl (params_van.pkl or epoch_*.pkl) as native pytrees.

    Returns a dict with whichever of {params_van, params_flow, x, key,
    epoch_data} the file provides; a bare haiku dict (params_van.pkl) yields
    just {"params_van": ...}.
    """
    data = load_data(filename)
    if "params_van" not in data:  # bare pretrained VAN params
        return {"params_van": convert_reference_van(data, num_layers, dtype)}

    out = {"params_van": convert_reference_van(data["params_van"], num_layers, dtype)}
    if data.get("params_flow") is not None:
        out["params_flow"] = convert_reference_flow(data["params_flow"], depth, dtype)
    if "x" in data:
        x = np.asarray(data["x"], dtype)
        out["x"] = x.reshape(-1, *x.shape[-2:])  # strip the device axis
    if "keys" in data:
        out["key"] = np.asarray(data["keys"])[0]  # process-0 stream
    return out


def load_reference_into(filename: str, van, flow=None, num_layers: int = 2, depth: int = 2,
                        dtype=np.float32) -> dict:
    """``load_reference_checkpoint``, then the parameters into the port's
    modules (``van`` a ``models.transformer.Transformer``, ``flow`` a
    ``models.ferminet.FermiNet`` or None) through ``io/convert.py``.
    Returns the loaded dict."""
    from .convert import flow_from_numpy, van_from_numpy

    out = load_reference_checkpoint(filename, num_layers, depth, dtype)
    van_from_numpy(out["params_van"], van)
    if flow is not None and "params_flow" in out:
        flow_from_numpy(out["params_flow"], flow)
    return out
