"""Parameter and optimizer-state interchange with the JAX package, as numpy
trees.

``params_from_jax`` takes a reference-layout parameter tree whose leaves
are numpy arrays (``jax.tree.map(np.asarray, params)`` on the JAX side, or a
checkpoint read by ``utils/checkpoint.py``) and returns the same tree of
float32 torch tensors; ``params_to_jax`` is its inverse. Both packages then
compute the same function from the same numbers. ``quantized_from_jax``
carries the int8 render tier's weights and scales across the same way.

``opt_state_to_jax`` writes the port's optimizer state
(:class:`~keras_nerf_tpu_torch.models.engine.Optimizer`) in flax's
state-dict form of the optax state the JAX package builds for the same
optimizer (``serialization.to_state_dict(optax.adam(lr).init(params))``):
tuples and lists become dicts keyed ``"0"``, ``"1"``, …; Adam is
``{"0": {"count", "mu", "nu"}, "1": {}}``, with ``"1": {"count"}`` when the
learning rate is a schedule; SGD is ``{"0": {}, "1": {}}`` likewise.
``opt_state_from_jax`` reads that form back (lists or digit-keyed dicts).
"""

from __future__ import annotations

import numpy as np
import torch

from keras_nerf_tpu_torch.device import resolve_device


def params_from_jax(tree, device=None):
    """Nested dicts/lists of numpy arrays -> the same nesting of float32
    tensors on ``device`` (the card unless the caller says otherwise)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        if tree and all(k.isdigit() for k in tree):
            return [params_from_jax(tree[str(i)], device)
                    for i in range(len(tree))]
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return torch.as_tensor(np.array(tree, dtype=np.float32), device=device)


def params_to_jax(tree):
    """Inverse of :func:`params_from_jax`: tensors -> float32 numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_jax(v) for v in tree]
    return tree.detach().to("cpu", torch.float32).numpy()


def quantized_from_jax(q: dict, device=None) -> dict:
    """The JAX package's ``quantize_packed`` dict (numpy leaves, lists with
    None kept) -> the port's (:func:`~keras_nerf_tpu_torch.kernels.quantize.
    quantize_packed`): int8 weights stay int8, scales and biases float32, on
    ``device`` (the card unless the caller says otherwise)."""
    device = resolve_device(device)

    def leaf(x):
        if x is None:
            return None
        a = np.asarray(x)
        a = a if a.dtype == np.int8 else a.astype(np.float32)
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return {k: [leaf(x) for x in v] if isinstance(v, (list, tuple))
            else leaf(v) for k, v in q.items()}


def state_dict_form(tree):
    """Lists -> dicts keyed ``"0"``, ``"1"``, …, as flax stores them."""
    if isinstance(tree, dict):
        return {k: state_dict_form(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): state_dict_form(v) for i, v in enumerate(tree)}
    return tree


def _count(n: int) -> np.ndarray:
    return np.asarray(n, dtype=np.int32)


def opt_state_to_jax(state: dict) -> dict:
    """The port's optimizer state -> flax's state-dict form of optax's."""
    first = {}
    if "mu" in state:
        first = {"count": _count(state["count"]),
                 "mu": state_dict_form(params_to_jax(state["mu"])),
                 "nu": state_dict_form(params_to_jax(state["nu"]))}
    second = ({"count": _count(state["schedule_count"])}
              if "schedule_count" in state else {})
    return {"0": first, "1": second}


def opt_state_from_jax(tree, device=None) -> dict:
    """Inverse of :func:`opt_state_to_jax`; ``tree`` may hold lists where
    flax keeps digit-keyed dicts."""
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    first, second = tree["0"], tree["1"]
    state = {}
    if first:
        state = {"count": int(np.asarray(first["count"])),
                 "mu": params_from_jax(first["mu"], device),
                 "nu": params_from_jax(first["nu"], device)}
    if second:
        state["schedule_count"] = int(np.asarray(second["count"]))
    return state
