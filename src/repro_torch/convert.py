"""Configs, and parameter, adapter and trainable trees, from the JAX
package, through numpy, and back to numpy for comparison.

``jax.random`` streams cannot be reproduced in PyTorch, so the tests run
both packages on weights the JAX package made: the caller turns the JAX
tree into numpy arrays (``jax.tree.map(np.asarray, tree)``) and these
functions rebuild it as tensors.  The layouts already agree leaf for leaf
(``blocks.pos{i}`` stacked over ``n_periods`` for every position of the
period, attention or Mamba, ``x @ W`` weights; a Mamba block's ``dt_bias``,
``A_log`` and ``D`` stay fp32 in a bf16 model), so the conversion only
changes the container type.  This module imports neither
``jax`` nor the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import configs


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


def config_from_jax(jcfg) -> configs.ModelConfig:
    """The port's ModelConfig with the same field values as a JAX
    package ``ModelConfig`` (read field by field, so no JAX import)."""
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(configs.ModelConfig)}
    kw["moe"] = configs.MoEConfig(**dataclasses.asdict(jcfg.moe))
    kw["ssm"] = configs.SSMConfig(**dataclasses.asdict(jcfg.ssm))
    kw["lora"] = configs.LoRAConfig(**dataclasses.asdict(jcfg.lora))
    return configs.ModelConfig(**kw)


def params_from_jax(tree: Dict[str, Any], device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """A ``repro.models.model.init_params`` tree (numpy leaves) -> the
    port's parameter tree.  ``dtype`` optionally casts every leaf."""
    return _tree(tree, device, dtype)


def rescalers_from_jax(by_k: Dict[int, Any], device="cuda"
                       ) -> Dict[int, Dict[str, torch.Tensor]]:
    """``{k: rescaler tree}`` (``{"pos{j}": (n_periods,)}`` fp32 per tier,
    one entry per MoE position ``j`` of the period, as
    ``repro.core.lora.init_rescalers`` makes them) -> tensors, for the
    serving engine's ``rescaler_by_k``."""
    return {int(k): _tree(t, device, None) for k, t in by_k.items()}


def lora_from_jax(tree: Dict[str, Any], device="cuda",
                  dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """A ``repro.core.lora.init_lora`` adapter tree (numpy leaves) -> the
    port's adapter tree."""
    return _tree(tree, device, dtype)


def trainable_from_jax(tree: Dict[str, Any], device="cuda",
                       dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """A trainable tree ``{"lora": ..., "rescaler": ...}`` (numpy leaves)
    -> tensors.  ``dtype`` casts the adapters; rescalers stay fp32."""
    out = {}
    if tree.get("lora") is not None:
        out["lora"] = _tree(tree["lora"], device, dtype)
    if tree.get("rescaler") is not None:
        out["rescaler"] = _tree(tree["rescaler"], device, None)
    return out


def to_numpy(tree) -> Any:
    """A tree of tensors -> the same tree of numpy arrays (fp32 for bf16
    leaves, which numpy has no type for), for comparing with the
    reference."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
