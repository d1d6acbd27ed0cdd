"""Carry policy weights and optimizer states between the JAX package and
the port.

The JAX package's ActorCritic params are a nested dict in the flax layout
(dense kernels [in, out]); the port's ActorCritic state_dict uses
nn.Linear's [out, in]. GRU weights keep the [in, 3H] / [H, 3H] layout in
both. Names:

  params/encoder/{fwd,bwd}/{w_ih,w_hh,b_ih,b_hh} <-> encoder.{fwd,bwd}.*
  params/encoder/ln/{scale,bias}                 <-> encoder.ln.{weight,bias}
  params/{actor,critic}/dense_i/kernel           <-> {actor,critic}.layers.i.weight (transposed)
  params/{actor,critic}/dense_i/bias             <-> {actor,critic}.layers.i.bias
  params/log_std                                 <-> log_std

The arrays are copied unchanged, so a round trip is exact.

Optimizer states: the JAX package's pi and vf optimizers are masked optax
chains holding one Adam state (`count`, and moments `mu`, `nu` in the
params' tree, with an empty MaskedNode at every leaf outside the mask).
`optax_adam_to_torch` loads one into a torch.optim.Adam over the same
parameters (`step` = count, `exp_avg` = mu, `exp_avg_sq` = nu);
`torch_adam_to_optax` writes a torch Adam's state back into such a tree.
Both walk the state by its fields and import nothing of optax.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_GRU = ("w_ih", "w_hh", "b_ih", "b_hh")


def _leaves(p: Dict[str, Any]) -> Iterator[Tuple[str, Tuple[str, ...], bool]]:
    """(state_dict name, path in the flax tree, transposed) for every
    parameter of the flax tree `p` (without its "params" root)."""
    enc = p["encoder"]
    for direction in ("fwd", "bwd"):
        if direction in enc:
            for w in _GRU:
                yield f"encoder.{direction}.{w}", ("encoder", direction, w), False
    yield "encoder.ln.weight", ("encoder", "ln", "scale"), False
    yield "encoder.ln.bias", ("encoder", "ln", "bias"), False
    for head in ("actor", "critic"):
        layers = sorted(p[head], key=lambda k: int(k.split("_")[1]))
        for i, name in enumerate(layers):
            yield f"{head}.layers.{i}.weight", (head, name, "kernel"), True
            yield f"{head}.layers.{i}.bias", (head, name, "bias"), False
    yield "log_std", ("log_std",), False


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _root(tree):
    return tree["params"] if "params" in tree else tree


def _to_torch(a, transposed: bool) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(np.array(a.T if transposed else a, copy=True))


def flax_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """{'params': {...}} of numpy arrays (flax layout) -> port state_dict."""
    p = _root(params)
    return {name: _to_torch(_get(p, path), tr) for name, path, tr in _leaves(p)}


def state_dict_to_flax(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Port state_dict -> {'params': {...}} of numpy arrays (flax layout)."""
    def a(name):
        return sd[name].detach().cpu().numpy().copy()

    enc: Dict[str, Any] = {}
    for direction in ("fwd", "bwd"):
        if f"encoder.{direction}.w_ih" in sd:
            enc[direction] = {w: a(f"encoder.{direction}.{w}") for w in _GRU}
    enc["ln"] = {"scale": a("encoder.ln.weight"), "bias": a("encoder.ln.bias")}
    out: Dict[str, Any] = {"encoder": enc}
    for head in ("actor", "critic"):
        n = sum(1 for k in sd if k.startswith(f"{head}.layers.") and k.endswith(".weight"))
        out[head] = {f"dense_{i}": {"kernel": a(f"{head}.layers.{i}.weight").T.copy(),
                                    "bias": a(f"{head}.layers.{i}.bias")}
                     for i in range(n)}
    out["log_std"] = a("log_std")
    return {"params": out}


def _is_masked(leaf) -> bool:
    """optax's MaskedNode is an empty NamedTuple."""
    return leaf is None or (isinstance(leaf, tuple) and len(leaf) == 0)


def _is_adam(node) -> bool:
    return all(hasattr(node, f) for f in ("count", "mu", "nu"))


def _find_adam(state):
    if _is_adam(state):
        return state
    children = state.values() if isinstance(state, dict) else (
        state if isinstance(state, (tuple, list)) else ())
    for child in children:
        found = _find_adam(child)
        if found is not None:
            return found
    return None


def optax_adam_to_torch(opt_state, optimizer: torch.optim.Adam,
                        ac: torch.nn.Module) -> None:
    """Load the Adam state inside a JAX optimizer state (numpy leaves) into
    `optimizer`, whose parameters are `ac`'s. Raises if the optax mask and
    the optimizer's parameters differ."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optimizer state")
    mu, nu = _root(adam.mu), _root(adam.nu)
    params = dict(ac.named_parameters())
    held = {id(p) for g in optimizer.param_groups for p in g["params"]}
    step = float(np.asarray(adam.count))
    for name, path, tr in _leaves(mu):
        p, m = params[name], _get(mu, path)
        if _is_masked(m) != (id(p) not in held):
            raise ValueError(f"{name}: the optax mask and the optimizer's "
                             "parameters differ")
        if _is_masked(m):
            continue
        optimizer.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": _to_torch(m, tr).to(p.device, p.dtype),
            "exp_avg_sq": _to_torch(_get(nu, path), tr).to(p.device, p.dtype)}


def torch_adam_to_optax(optimizer: torch.optim.Adam, ac: torch.nn.Module,
                        template):
    """The JAX optimizer state `template` (numpy leaves, e.g. a fresh
    `tx.init(params)`) with its Adam count and moments taken from
    `optimizer`. Masked leaves stay as they are."""
    params = dict(ac.named_parameters())
    steps = {float(s["step"]) for s in optimizer.state.values() if "step" in s}
    if len(steps) > 1:
        raise ValueError(f"the parameters' Adam steps differ: {sorted(steps)}")
    step = steps.pop() if steps else 0.0

    def moments(tree, key):
        root = _root(tree)
        out = _copy_tree(root)
        for name, path, tr in _leaves(root):
            if _is_masked(_get(root, path)):
                continue
            st = optimizer.state.get(params[name])
            val = (st[key].detach().cpu().numpy() if st else
                   np.zeros(tuple(params[name].shape), np.float32))
            _get(out, path[:-1])[path[-1]] = np.array(val.T if tr else val, copy=True)
        return {"params": out} if "params" in tree else out

    def rebuild(node):
        if _is_adam(node):
            return node._replace(count=np.asarray(step).astype(np.asarray(node.count).dtype),
                                 mu=moments(node.mu, "exp_avg"),
                                 nu=moments(node.nu, "exp_avg_sq"))
        if isinstance(node, dict):
            return {k: rebuild(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*[rebuild(v) for v in node])
        if isinstance(node, (tuple, list)):
            return type(node)(rebuild(v) for v in node)
        return node

    return rebuild(template)


def _copy_tree(tree):
    return {k: _copy_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else tree
