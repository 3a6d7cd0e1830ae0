"""Parameter trees from the JAX package, through numpy.

``jax.random`` streams cannot be reproduced in PyTorch, so the tests run
both packages on weights the JAX package made: the caller turns the JAX
tree into numpy arrays (``jax.tree.map(np.asarray, tree)``) and these
functions rebuild it as tensors.  The layouts already agree leaf for leaf
(``blocks.pos{i}`` stacked over ``n_periods``, ``x @ W`` weights), so the
conversion only changes the container type.  This module imports neither
``jax`` nor the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def _leaf(arr, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":      # ml_dtypes: widen exactly, then narrow
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))      # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


def _tree(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tree(v, device, dtype) for k, v in tree.items()}
    return _leaf(tree, device, dtype)


def params_from_jax(tree: Dict[str, Any], device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """A ``repro.models.model.init_params`` tree (numpy leaves) -> the
    port's parameter tree.  ``dtype`` optionally casts every leaf."""
    return _tree(tree, device, dtype)


def rescalers_from_jax(by_k: Dict[int, Any], device="cuda"
                       ) -> Dict[int, Dict[str, torch.Tensor]]:
    """``{k: rescaler tree}`` (``{"pos0": (n_periods,)}`` fp32 per tier,
    as ``repro.core.lora.init_rescalers`` makes them) -> tensors, for the
    serving engine's ``rescaler_by_k``."""
    return {int(k): _tree(t, device, None) for k, t in by_k.items()}
