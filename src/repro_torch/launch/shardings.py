"""Param / optimizer / input / cache sharding rules per (arch x mesh).

The reference package's ``launch/shardings.py`` on DTensor. Name-based
rules over the param tree's paths (every projection is a ``.../w`` leaf;
stacked layer params carry a leading [L] axis mapped to None). The specs
are the reference's ``PartitionSpec`` entries as tuples
(``distributed.sharding``); ``tree_shardings``, ``batch_shardings`` and
``cache_shardings`` return DTensor placements per leaf, and
``distribute_tree`` places a tree on a ``DeviceMesh`` with them.

Key decisions (the reference's):
  * batch        -> ("pod","data"); model axis carries TP everywhere
  * attn heads / kv heads / d_ff / vocab -> "model"
  * FSDP (cfg.fsdp): the non-model param dim ("embed") -> "data"
  * MoE: experts -> "model" when n_experts >= model-axis size (kimi: 384;
    grok-1's 8 experts too at the port's model = 8), otherwise the
    per-expert FFN dim -> "model"
  * SSM: params replicated over model; activations shard on ssm heads
  * decode caches: batch -> ("pod","data"), cache seq -> "model"
  * optimizer moments/master/error mirror the param specs exactly (ZeRO)

A ``mesh`` here is a ``DeviceMesh`` or a ``launch.mesh.MeshShape`` (dims
and sizes alone): the rules and specs need no process group.
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (Spec, base_rules, distribute,
                                              placements, spec_shards)
from repro_torch.launch.mesh import axis_size
from repro_torch.nn.module import tree_flatten_with_paths

Tree = Any
OPT_PREFIXES = ("mu/", "nu/", "master/", "error/")


def build_rules(cfg: ModelConfig, mesh, serve: bool = False) -> Dict:
    multi_pod = "pod" in tuple(mesh.mesh_dim_names)
    model_size = axis_size(mesh, "model")
    fsdp = cfg.fsdp
    if serve and fsdp:
        # serving profile: FSDP re-gathers every layer's weights per decoded
        # token; pure TP wins whenever the TP-sharded params fit (<= 8 GiB a
        # device leaves room for the cache)
        from repro_torch.models.lm import count_params
        per_chip = count_params(cfg) * 2 / model_size
        if per_chip <= 8 * 2**30:
            fsdp = False
    rules = base_rules(multi_pod=multi_pod, fsdp=fsdp)
    rules["experts"] = ("model",) if cfg.n_experts >= model_size else None
    rules["moe_ffn"] = None if rules["experts"] else ("model",)
    rules["ssm_inner"] = None
    # GQA kv heads that don't divide the model axis: replicate the kv
    # activations over model (wk/wv params still shard on their flattened
    # output dim)
    if cfg.n_kv_heads and cfg.n_kv_heads % model_size != 0:
        rules["kv"] = None
    if cfg.n_heads and cfg.n_heads % model_size != 0:
        rules["heads"] = None
    return rules


def _ax(rules, name):
    ax = rules.get(name)
    if ax is None:
        return None
    return ax if len(ax) > 1 else ax[0]


def param_spec(path: str, ndim: int, cfg: ModelConfig, rules: Dict) -> Spec:
    """The spec of one param leaf identified by its tree path."""
    a = lambda name: _ax(rules, name)           # noqa: E731
    stacked = path.startswith("layers/")
    lead = (None,) if stacked else ()
    # photonic serving storage: the int carrier shards like the fp weight;
    # per-channel scales are tiny -> replicate
    if path.endswith("/ws"):
        return (None,) * ndim
    if path.endswith("/wq"):
        path = path[:-3] + "/w"

    def spec(*axes):
        return lead + axes

    if path.endswith("embed/table"):
        return (a("vocab"), a("embed"))
    if path.startswith("lm_head"):
        return (a("embed"), a("vocab"))
    if path.startswith("frontend"):
        return () if ndim == 1 else (None, None)
    if "/attn/" in path:
        if "/wo/" in path:
            return spec(a("heads"), a("embed"))
        return spec(a("embed"), a("heads"))          # wq/wk/wv
    if "/mlp/" in path:
        if "/w_down/" in path:
            return spec(a("ffn"), a("embed"))
        return spec(a("embed"), a("ffn"))
    if "/moe/" in path:
        if path.endswith("router"):
            return spec(a("embed"), None)
        if "w_down" in path:
            return spec(a("experts"), a("moe_ffn"), a("expert_embed"))
        return spec(a("experts"), a("expert_embed"), a("moe_ffn"))
    if "/ssm/" in path:
        if "/in_proj/" in path:
            return spec(a("embed"), a("ssm_inner"))
        if "/out_proj/" in path:
            return spec(a("ssm_inner"), a("embed"))
        # conv/dt/a_log/d_skip/norm: replicate
        return spec(*([None] * (ndim - 1)))
    # norms, biases, everything else: replicated
    if stacked:
        return spec(*([None] * (ndim - 1)))
    return (None,) * ndim


def _sanitize(spec: Spec, shape, mesh) -> Spec:
    """Drop spec axes that don't divide the dimension (argument placements
    must divide evenly, as the reference's pjit arguments must)."""
    return tuple(None if e is None or shape[i] % spec_shards(e, mesh) else e
                 for i, e in enumerate(spec))


def leaf_spec(path: str, leaf, cfg: ModelConfig, mesh, rules: Dict) -> Spec:
    """The sanitized spec of one param or optimizer-state leaf: the
    optimizer's mu/nu/master/error mirror the param below them."""
    for prefix in OPT_PREFIXES:
        if path.startswith(prefix):
            path = path[len(prefix):]
    if path == "step" or leaf.ndim == 0:
        return ()
    return _sanitize(param_spec(path, leaf.ndim, cfg, rules), leaf.shape,
                     mesh)


def _map_paths(fn, tree: Tree, prefix: str = "") -> Tree:
    """``fn(path, leaf)`` over a nested dict, paths as
    ``tree_flatten_with_paths`` joins them."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def tree_specs(tree: Tree, cfg: ModelConfig, mesh, rules: Dict) -> Tree:
    """The spec of every leaf of a param or optimizer tree."""
    return _map_paths(lambda p, x: leaf_spec(p, x, cfg, mesh, rules), tree)


def tree_shardings(tree: Tree, cfg: ModelConfig, mesh, rules: Dict) -> Tree:
    """DTensor placements (one per mesh dim) of every leaf of a param or
    optimizer tree."""
    return _map_paths(lambda p, x: placements(
        leaf_spec(p, x, cfg, mesh, rules), mesh), tree)


def batch_spec(leaf, mesh, rules: Dict) -> Spec:
    b = _ax(rules, "batch")
    return _sanitize((b,) + (None,) * (leaf.ndim - 1), leaf.shape, mesh)


def batch_spec_placements(leaf, mesh, rules: Dict) -> list:
    return placements(batch_spec(leaf, mesh, rules), mesh)


def batch_shardings(batch: Dict, cfg: ModelConfig, mesh, rules: Dict) -> Dict:
    return {k: batch_spec_placements(v, mesh, rules)
            for k, v in batch.items()}


def cache_spec(path: str, leaf, mesh, rules: Dict) -> Spec:
    """Decode caches: [L, B, S, K, D] -> (None, batch, model-on-seq, ..)."""
    b = _ax(rules, "batch")
    if leaf.ndim == 0:
        return ()
    if "/kv/" in path or path.endswith("/k") or path.endswith("/v"):
        spec = (None, b, "model", None, None)      # sequence-sharded KV
    elif path.endswith("/ssm"):
        spec = (None, b, "model", None, None)      # [L, B, H, P, N]: heads
    elif path.endswith("/conv"):
        spec = (None, b, None, None)
    else:
        spec = (None,) * leaf.ndim
    return _sanitize(spec, leaf.shape, mesh)


def cache_specs(cache: Tree, mesh, rules: Dict) -> Tree:
    return _map_paths(lambda p, x: cache_spec(p, x, mesh, rules), cache)


def cache_shardings(cache: Tree, cfg: ModelConfig, mesh, rules: Dict
                    ) -> Tree:
    return _map_paths(lambda p, x: placements(
        cache_spec(p, x, mesh, rules), mesh), cache)


def place_tree(tree: Tree, mesh, placement_tree: Tree) -> Tree:
    """Every leaf of ``tree`` (full tensors, the same on every rank) as a
    DTensor on ``mesh`` under the matching placements; no communication."""
    if isinstance(tree, dict):
        return {k: place_tree(v, mesh, placement_tree[k])
                for k, v in tree.items()}
    return distribute(tree, mesh, placement_tree)


def distribute_tree(tree: Tree, cfg: ModelConfig, mesh, rules: Dict) -> Tree:
    """A param or optimizer tree placed on ``mesh`` by its rules."""
    return place_tree(tree, mesh, tree_shardings(tree, cfg, mesh, rules))


def split_ways(spec: Spec, mesh) -> int:
    """How many ways a leaf of ``spec`` is split over ``mesh``."""
    n = 1
    for e in spec:
        n *= spec_shards(e, mesh)
    return n


def per_rank_bytes(tree: Tree, specs: Tree, mesh) -> int:
    """Bytes one rank holds of ``tree`` (tensors or meta tensors) under
    ``specs`` (every sharded dim divides evenly)."""
    flat = dict(tree_flatten_with_paths(tree))
    spec_flat = dict(tree_flatten_with_paths(specs)) if isinstance(
        specs, dict) else {"": specs}
    total = 0
    for path, leaf in flat.items():
        total += (leaf.numel() * leaf.element_size()
                  // split_ways(spec_flat[path], mesh))
    return total
