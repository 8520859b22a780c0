"""Turn the JAX package's model parameters into the port's, so both compute
the same function in the tests.

The input is the JAX package's `Model.params` with every array converted to
numpy (for instance `jax.tree_util.tree_map(np.asarray, params)`): dense
weights are numpy arrays, quantized weights are objects with the JAX
QuantTensor's fields (q, scales, mins, d, dmin as numpy arrays; group,
ggml_type, transposed, packed, out_dim, sgroup). Nothing of JAX is imported.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops.qtensor import QuantTensor


def _tensor(a, device) -> torch.Tensor | None:
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    return t.to(device)


def _weight(w, device):
    if hasattr(w, "q") and hasattr(w, "scales"):
        return QuantTensor(
            q=_tensor(w.q, device), scales=_tensor(w.scales, device),
            mins=_tensor(w.mins, device), group=int(w.group), ggml_type=int(w.ggml_type),
            transposed=bool(w.transposed), packed=bool(w.packed), out_dim=int(w.out_dim),
            d=_tensor(w.d, device), dmin=_tensor(w.dmin, device), sgroup=int(w.sgroup))
    return _tensor(w, device)


def params_from_jax(jparams: dict[str, Any], device="cpu") -> dict[str, Any]:
    """JAX `Model.params` (arrays as numpy) -> the port's params on `device`."""
    out: dict[str, Any] = {}
    for key, val in jparams.items():
        if key == "layers":
            out["layers"] = [{k: _weight(w, device) for k, w in lw.items()} for lw in val]
        else:
            out[key] = _weight(val, device)
    return out
