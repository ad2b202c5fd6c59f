"""The zoo's model definition, every family of the zoo (twin of
``repro/models/transformer.py``).

* ``forward(params, cfg, batch)``      — full-sequence (prefill)
* ``serve_step(params, cfg, cache,…)`` — one-token decode against a cache
* ``loss_fn(params, cfg, batch)``      — chunked cross-entropy (training)

Parameters keep the reference's group-stacked tree: every leaf under
``params["layers"]`` (and ``params["enc"]["layers"]``) has a leading group
axis.  Where the reference scans over groups with ``jax.lax.scan``, the port
runs a Python loop over them.  An MoE layer runs ``moe.moe_ffn`` as the
reference does: its aux loss is summed over the layers of a forward and
dropped at decode, where each token is a dispatch group of its own.  The
encoder-decoder family (whisper) runs an encoder over the stub frontend's
frames, with rope and no mask, and a cross-attention after each decoder
layer's self-attention, whose keys and values enter the decode cache once,
at prefill (``ck``, ``cv``).  The VLM family puts its projected patch
embeddings before the tokens.

Under a mesh (``mesh=``, a ("data", "model") ``DeviceMesh``), ``prefill``
and ``serve_step`` serve every family but MoE on each rank's blocks:
the weights by ``rules.param_specs(..., profile="inference")``
(:func:`init_params` draws them block by block), the decode cache by
``rules.cache_specs`` (:func:`init_cache`), the batch's rows by
``rules.batch_specs``, with ``sharding.parallel.Plan``'s collectives (the
twin of the reference's ``shard_fn=`` serving path).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import (apply_rope, attention, decode_attention, dense,
                                       gelu_mlp, init_attn, init_dense, init_gelu_mlp,
                                       init_swiglu, layernorm, rmsnorm, rope_tables, swiglu)
from repro_torch.sharding import blocks
from repro_torch.sharding import parallel
from repro_torch.sharding import rules as R


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    mixer: str        # 'attn' | 'mamba' | 'rwkv'
    ffn: str          # 'dense' | 'moe' | 'none'
    cross: bool = False


def block_structure(cfg: ModelConfig) -> tuple[list[LayerDesc], int]:
    """(descs for one period, n_groups)."""
    if cfg.family == "ssm":
        return [LayerDesc("rwkv", "none")], cfg.n_layers
    period = cfg.attn_period if cfg.attn_period > 0 else 1
    if cfg.moe is not None:
        period = max(period, cfg.moe.moe_every)
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.n_layers} layers are not whole periods of {period}")
    descs = []
    for j in range(period):
        mixer = "attn" if cfg.is_attn_layer(j) else "mamba"
        ffn = "moe" if cfg.is_moe_layer(j) else "dense"
        descs.append(LayerDesc(mixer, ffn, cross=cfg.family == "encdec"))
    return descs, cfg.n_layers // period


def _norm_params(d, dtype, device):
    return {"w": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def _apply_norm(p, x, cfg):
    if cfg.family == "encdec":
        return layernorm(x, p["w"], p["b"], cfg.norm_eps)
    return rmsnorm(x, p["w"], cfg.norm_eps)


def _group(tree, g: int):
    """The parameters (or cache) of group ``g``: views into the stacked tree."""
    if isinstance(tree, dict):
        return {k: _group(v, g) for k, v in tree.items()}
    return tree[g]


def _groups(tree, n: int) -> list:
    """Every group's parameters, views from one ``unbind`` of each stacked
    leaf.  Under autograd a leaf then has one backward node, which stacks
    the groups' gradients once, where indexing it a group at a time would
    give each group's gradient the whole stacked shape and add them up:
    O(groups^2) traffic and several stacked-size buffers at once."""
    if isinstance(tree, dict):
        subs = {k: _groups(v, n) for k, v in tree.items()}
        return [{k: subs[k][g] for k in tree} for g in range(n)]
    return tree.unbind(0)


# ------------------------------------------------------------------ init ----
def init_layer(gen, desc: LayerDesc, cfg: ModelConfig, device) -> dict:
    d, dt = cfg.d_model, cfg.tdtype
    p = {"norm1": _norm_params(d, dt, device), "norm2": _norm_params(d, dt, device)}
    if desc.mixer == "attn":
        p["attn"] = init_attn(gen, cfg, device)
    elif desc.mixer == "mamba":
        p["mamba"] = mamba_mod.init_mamba(gen, cfg, device)
    else:  # rwkv
        p["tm"] = rwkv_mod.init_time_mix(gen, cfg, device)
        p["cm"] = rwkv_mod.init_channel_mix(gen, cfg, device)
    if desc.cross:
        p["norm_cross"] = _norm_params(d, dt, device)
        p["cross"] = init_attn(gen, cfg, device, with_bias=True, cross=True)
    if desc.ffn == "dense":
        p["ffn"] = (init_gelu_mlp(gen, d, cfg.d_ff, dt, device) if cfg.family == "encdec"
                    else init_swiglu(gen, d, cfg.d_ff, dt, device))
    elif desc.ffn == "moe":
        p["ffn"] = moe_mod.init_moe(gen, d, cfg.moe, dt, device)
    return p


def _no_cut(tree, path):
    return tree


def _init_tree(gen, cfg: ModelConfig, device, cut=_no_cut) -> dict:
    """The parameter tree, each drawn leaf passed through ``cut(tree,
    path)`` before it is kept: a group's leaves together as they are drawn,
    before the groups are stacked (``sharding.blocks.Cut``)."""
    descs, n_groups = block_structure(cfg)
    d, dt = cfg.d_model, cfg.tdtype

    def one_group():
        return cut({f"l{j}": init_layer(gen, descs[j], cfg, device) for j in range(len(descs))},
                   "layers")

    def stack(trees):
        # each group's leaf is dropped once stacked, so the model is held
        # once plus one stacked leaf, not twice
        if isinstance(trees[0], dict):
            return {k: stack([t.pop(k) for t in trees]) for k in list(trees[0])}
        return torch.stack(trees)

    embed = torch.randn((cfg.vocab, d), generator=gen, dtype=torch.float32, device=device)
    params = {"embed": cut((embed * 0.02).to(dt), "embed")}
    params["final_norm"] = cut(_norm_params(d, dt, device), "final_norm")
    params["layers"] = stack([one_group() for _ in range(n_groups)])
    if not cfg.tie_embeddings:
        params["head"] = cut(init_dense(gen, d, cfg.vocab, dt, device), "head")
    if cfg.family == "encdec":
        enc_desc = LayerDesc("attn", "dense")
        pos = torch.randn((cfg.n_frames, d), generator=gen, dtype=torch.float32, device=device)
        params["enc"] = {
            "proj": cut(init_dense(gen, cfg.d_frontend, d, dt, device), "enc/proj"),
            "pos": cut((pos * 0.01).to(dt), "enc/pos"),
            "layers": stack([cut(init_layer(gen, enc_desc, cfg, device), "enc/layers")
                             for _ in range(cfg.n_enc_layers)]),
            "final_norm": cut(_norm_params(d, dt, device), "enc/final_norm"),
        }
    if cfg.family == "vlm":
        params["projector"] = cut({
            "w1": init_dense(gen, cfg.d_frontend, d, dt, device),
            "b1": torch.zeros((d,), dtype=dt, device=device),
            "w2": init_dense(gen, d, d, dt, device),
            "b2": torch.zeros((d,), dtype=dt, device=device),
        }, "projector")
    return params


def init_params(seed: int, cfg: ModelConfig, *, device="cuda", mesh=None,
                profile: str = "train") -> dict:
    """Random parameters in the reference's tree, from a ``torch.Generator``
    seeded with ``seed``, made on ``device``.

    With a ``mesh``, this rank's blocks of them under
    ``rules.param_specs(..., profile)``: the same draws in the same order,
    each group's leaves cut to their blocks as soon as they are drawn and
    only then stacked (as ``embed``, ``head`` and the projector are), so the
    result is bit for bit ``blocks.shard_tree`` of the whole tree and no
    whole stacked leaf is ever held."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if mesh is None:
        return _init_tree(gen, cfg, dev)
    specs = R.param_specs(param_spec(cfg), mesh, profile=profile)
    return _init_tree(gen, cfg, dev, blocks.Cut(specs, mesh))


def param_spec(cfg: ModelConfig) -> dict:
    """The parameter tree of ``cfg`` as ``meta`` tensors: shapes and dtypes,
    no memory."""
    return _init_tree(None, cfg, torch.device("meta"))


# the plans of the last few (config, mesh) pairs served, each holding its
# mesh, so that no other mesh takes its id while it is kept
_plans: dict = {}


def _plan(cfg: ModelConfig, mesh):
    """``None`` without a mesh, else this rank's ``parallel.Plan`` on it for
    the inference profile's blocks (a config it does not serve raises),
    built once for each config and mesh."""
    if mesh is None:
        return None
    key = (cfg, id(mesh))
    if key not in _plans:
        if len(_plans) >= 8:
            _plans.clear()
        _plans[key] = parallel.Plan(
            cfg, mesh, R.param_specs(param_spec(cfg), mesh, profile="inference"))
    return _plans[key]


# ----------------------------------------------------------- full-seq fwd ----
def _qkv(p, x, cfg, cross_src=None):
    """q (B,S,H,hd), k and v (B,Sk,K,hd) for the heads whose columns ``p``
    holds: every head, or under a mesh this rank's."""
    b, s, _ = x.shape
    hd = cfg.hd
    src = x if cross_src is None else cross_src
    q = dense(x, p["wq"], p.get("bq")).reshape(b, s, -1, hd)
    k = dense(src, p["wk"], p.get("bk")).reshape(b, src.shape[1], -1, hd)
    v = dense(src, p["wv"], p.get("bv")).reshape(b, src.shape[1], -1, hd)
    return q, k, v


def _attn_seq(p, x, cfg, positions, *, causal, window, cross_src=None, par=None, path=""):
    """Attention over a sequence.  Under a plan ``par`` (``path``: the
    layer's ``layers/l{j}/attn``), on this rank's heads with ``wo``'s rows
    summed over "model", or where its heads are not whole blocks on the
    layer's leaves all-gathered; the returned k and v hold the heads it
    computed."""
    heads = par is not None and par.heads(path)
    if par is not None and not heads:
        p = par.whole_leaves(p, path)
    q, k, v = _qkv(p, x, cfg, cross_src)
    if cross_src is None:  # rope only for self-attention
        cos, sin = rope_tables(positions, cfg.hd, cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    out = attention(q, k, v, causal=causal, window=window)
    b, s = x.shape[0], x.shape[1]
    out = out.reshape(b, s, -1)
    if heads:
        return par.row_sum(out, p["wo"], x.dtype), (k, v)
    return dense(out, p["wo"]), (k, v)


def _ffn(p, h, cfg, par=None, path=""):
    """The dense FFN (the GELU MLP for the encoder-decoder, else SwiGLU).
    Under a plan ``par`` on this rank's hidden units, the down projection's
    rows summed over "model" (the GELU MLP's replicated ``b_out`` added once,
    after the sum), or on the leaves all-gathered where they are not cut
    so."""
    mlp = gelu_mlp if cfg.family == "encdec" else swiglu
    if par is None:
        return mlp(h, p)
    if not par.ffn_split(path):
        return mlp(h, par.whole_leaves(p, path))
    if cfg.family == "encdec":
        hid = F.gelu(dense(h, p["w_in"], p["b_in"]), approximate="tanh")
        return par.row_sum(hid, p["w_out"], h.dtype) + p["b_out"]
    return par.row_sum(F.silu(dense(h, p["w_gate"])) * dense(h, p["w_up"]), p["w_down"],
                       h.dtype)


def apply_layer_seq(p, desc: LayerDesc, x, cfg, positions, *, causal=True,
                    window=None, enc_out=None, collect_cache=False, par=None, path=""):
    """One sublayer over a full sequence.  Returns (x, aux, cache_entry).
    A cross layer attends to ``enc_out`` where it is given, and skips its
    cross-attention where it is not, as the reference does.  ``par``,
    ``path`` (``layers/l{j}``, ``enc/layers``): a rank's plan under a mesh;
    its cache entries are then the rank's heads and channels (``k``, ``v``,
    ``wkv``, ``conv``, ``ssm``, ``ck``, ``cv``) and the whole last row
    (``tm_prev``, ``cm_prev``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = {}
    h = _apply_norm(p["norm1"], x, cfg)
    if desc.mixer == "attn":
        att, (k, v) = _attn_seq(p["attn"], h, cfg, positions, causal=causal, window=window,
                                par=par, path=f"{path}/attn")
        if collect_cache:
            cache["k"], cache["v"] = k, v
    elif desc.mixer == "mamba":
        att, state = mamba_mod.mamba_seq(p["mamba"], h, cfg, par=par, path=f"{path}/mamba")
        if collect_cache:
            cache["conv"], cache["ssm"] = state
    else:  # rwkv: norm1 -> time-mix
        st = rwkv_mod.init_state(cfg, x.shape[0], x.dtype, x.device)
        att, tm_prev, wkv = rwkv_mod.time_mix(p["tm"], h, st["tm_prev"], st["wkv"], cfg, par,
                                              f"{path}/tm")
        if collect_cache:
            cache["tm_prev"], cache["wkv"] = tm_prev, wkv
    x = x + att
    if desc.cross and enc_out is not None:
        h = _apply_norm(p["norm_cross"], x, cfg)
        catt, (ck, cv) = _attn_seq(p["cross"], h, cfg, positions, causal=False, window=None,
                                   cross_src=enc_out, par=par, path=f"{path}/cross")
        if collect_cache:
            cache["ck"], cache["cv"] = ck, cv
        x = x + catt
    h = _apply_norm(p["norm2"], x, cfg)
    if desc.ffn == "dense":
        f = _ffn(p["ffn"], h, cfg, par, f"{path}/ffn")
    elif desc.ffn == "moe":
        f, aux = moe_mod.moe_ffn(h, p["ffn"], cfg.moe)
    else:  # rwkv channel mix
        f, cm_prev = rwkv_mod.channel_mix(p["cm"], h, torch.zeros_like(h[:, 0]), par,
                                          f"{path}/cm")
        if collect_cache:
            cache["cm_prev"] = cm_prev
    return x + f, aux, cache


def _remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward where grad
    mode is on (the reference's ``jax.checkpoint`` around each scanned
    group, ``policy=nothing_saveable``); a plain call otherwise."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _no_gather(tree, path):
    return tree


def _gather_top(params, gather):
    """``params`` with every leaf outside the group stacks (``layers``,
    ``enc/layers``) through ``gather``: once a step."""
    out = {k: v if k in ("layers", "enc") else gather(v, k) for k, v in params.items()}
    if "enc" in params:
        out["enc"] = {k: v if k == "layers" else gather(v, f"enc/{k}")
                      for k, v in params["enc"].items()}
    return out


def _encoder(params, cfg, frames, gather=_no_gather, par=None):
    """Whisper-style encoder on stub frame embeddings (B, F, d_frontend):
    rope at positions 0..F-1 and no mask in its self-attention; each layer
    recomputed in the backward, as the reference checkpoints it, its
    parameters gathered inside the recompute.  Under a plan ``par`` (the
    sharded prefill's), ``enc/proj`` and ``enc/pos``'s column blocks are
    all-gathered over "model" and each layer splits as the decoder's."""
    enc = params["enc"]
    if par is None:
        x = dense(frames, enc["proj"]) + enc["pos"][None]
    else:
        x = par.whole(frames, enc["proj"], enc["pos"][None], "enc/proj", "enc/pos")
    desc = LayerDesc("attn", "dense")
    positions = torch.arange(frames.shape[1], device=x.device)

    def layer(p, x):
        p = gather(p, "enc/layers")
        return apply_layer_seq(p, desc, x, cfg, positions, causal=False, par=par,
                               path="enc/layers")[0]
    for p in _groups(enc["layers"], cfg.n_enc_layers):
        x = _remat(layer, p, x)
    return _apply_norm(enc["final_norm"], x, cfg)


def embed_inputs(params, cfg, batch, *, par=None):
    """Token (+frontend) embedding -> (x (B,S,D), positions (S,), enc_out=None).

    A VLM puts ``tanh(pe @ w1 + b1) @ w2 + b2`` of its patch embeddings, in
    the embedding's dtype, before the tokens, and its positions run over
    both; the encoder-decoder's encoder runs in :func:`forward`.  Under a
    plan ``par`` (the sharded prefill's), from this rank's column blocks of
    ``embed`` and the projector, each output all-gathered over "model"."""
    tokens = batch["tokens"]
    if par is None:
        x = params["embed"][tokens.long()]
    else:
        x = par.embed(params["embed"], tokens)
    if cfg.family == "vlm":
        pj, pe = params["projector"], batch["patch_embeds"]
        if par is None:
            h = torch.tanh(dense(pe, pj["w1"], pj["b1"]))
            y = dense(h, pj["w2"], pj["b2"])
        else:
            h = torch.tanh(par.whole(pe, pj["w1"], pj["b1"], "projector/w1", "projector/b1"))
            y = par.whole(h, pj["w2"], pj["b2"], "projector/w2", "projector/b2")
        x = torch.cat([y.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    return x, positions, None


def forward(params, cfg: ModelConfig, batch: dict, *, collect_cache=False, gather=None):
    """Full-sequence forward.  batch: tokens (B,S_text) [+ patch_embeds
    (B,P,df) | frames (B,F,df)] on the parameters' device.

    Returns dict(x=final-normed (B,S,D), aux, cache=group-stacked cache or
    None, positions).  Where grad mode is on, each group's activations are
    recomputed in the backward (:func:`_remat`), so a training step runs
    every layer's forward twice.

    ``gather(tree, path)`` (the twin of the reference's ``shard_fn``; the
    identity where ``None``) turns ``params``' sub-nest at ``path`` into
    whole tensors, where ``params`` holds a rank's blocks of a sharded
    tree (``sharding.blocks.Gather``): the top-level leaves once, each
    group's parameters inside the function :func:`_remat` recomputes, so
    that a group's whole weights live only while it runs.
    """
    gather = gather or _no_gather
    return _forward(_gather_top(params, gather), cfg, batch, collect_cache, gather)


def _forward(params, cfg, batch, collect_cache, gather):
    """:func:`forward` on ``params`` whose top-level leaves are gathered."""
    descs, n_groups = block_structure(cfg)
    x, positions, _ = embed_inputs(params, cfg, batch)
    enc_out = (_encoder(params, cfg, batch["frames"], gather) if cfg.family == "encdec"
               else None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = [dict() for _ in descs]

    def group(group_p, x, aux, enc_out):
        group_p = gather(group_p, "layers")
        cs = []
        for j, desc in enumerate(descs):
            x, a, c = apply_layer_seq(group_p[f"l{j}"], desc, x, cfg, positions, causal=True,
                                      window=cfg.sliding_window, enc_out=enc_out,
                                      collect_cache=collect_cache)
            aux = aux + a
            cs.append(c)
        return x, aux, cs
    for group_p in _groups(params["layers"], n_groups):
        x, aux, cs = _remat(group, group_p, x, aux, enc_out)
        for j, c in enumerate(cs):
            for key, t in c.items():
                caches[j].setdefault(key, []).append(t)
    x = _apply_norm(params["final_norm"], x, cfg)
    cache = None
    if collect_cache:
        cache = {f"l{j}": {key: torch.stack(ts) for key, ts in c.items()}
                 for j, c in enumerate(caches)}
    return {"x": x, "aux": aux, "cache": cache, "positions": positions}


def logits_from_x(params, cfg, x, *, par=None):
    """``x @ head`` (``embed.T`` where tied).  Under a plan ``par`` (the
    sharded prefill's and decode's), from this rank's block: ``head``'s
    vocab columns all-gathered over "model", a tied ``embed``'s d_model
    block summed."""
    if par is not None:
        return par.logits(params, x)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ head


def _chunk_ce(xc, lc, head):
    """Summed cross-entropy ``logsumexp - gold`` of one chunk's f32 logits."""
    logits = (xc @ head).float()
    gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def loss_fn(params, cfg: ModelConfig, batch: dict, *, chunk: int = 512,
            aux_weight: float = 0.01, gather=None) -> tuple:
    """Chunked softmax cross-entropy (twin of the reference's ``loss_fn``):
    the (B, S, V) logits are never held in f32, as each ``chunk`` of
    positions (shrunk until it divides S) makes its logits, sums its
    cross-entropy, and where grad mode is on recomputes them in the backward
    rather than keeping them.  A VLM's patch positions carry no loss.
    ``gather``: as :func:`forward`'s (the top-level leaves gathered once).

    Returns ``(ce + aux_weight * aux, {"ce": ce, "aux": aux})``, ce the mean
    over the B * S labelled positions."""
    gather = gather or _no_gather
    params = _gather_top(params, gather)
    out = _forward(params, cfg, batch, False, gather)
    x, aux = out["x"], out["aux"]
    labels = batch["labels"]
    if cfg.family == "vlm":
        x = x[:, -labels.shape[1]:, :]
    b, s, d = x.shape
    chunk = min(chunk, s)
    while s % chunk:
        chunk -= 1
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        total = total + _remat(_chunk_ce, x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk], head)
    ce = total / (b * s)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


# ------------------------------------------------------------------ cache ----
def cache_len_for(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=None, *,
               device="cuda", mesh=None) -> dict:
    """Empty decode cache (group-stacked leading dim) for ``batch`` rows.
    Under a ``mesh``, this rank's blocks of it by ``rules.cache_specs``
    (its rows over "data"; over "model" its slots for every kv head, its
    heads of ``wkv``, ``ck`` and ``cv``, its channels of ``conv`` and
    ``ssm``, its d_model block of ``tm_prev`` and ``cm_prev``), as a
    ``parallel.ShardedCache`` that knows the whole cache's slot count."""
    dev = resolve_device(device)
    if mesh is None:
        return _cache_tree(cfg, batch, seq_len, dtype, dev)
    parallel.refuse(cfg)
    meta = cache_spec(cfg, batch, seq_len, dtype)
    specs = R.cache_specs(meta, mesh)

    def block(path, shape):
        layer, key = path.split("/")
        return tuple(blocks.local_block(meta[layer][key], specs[layer][key], mesh).shape)
    return parallel.ShardedCache(_cache_tree(cfg, batch, seq_len, dtype, dev, block),
                                 cache_len_for(cfg, seq_len))


def cache_spec(cfg: ModelConfig, batch: int, seq_len: int, dtype=None) -> dict:
    """:func:`init_cache`'s tree as ``meta`` tensors: shapes and dtypes, no
    memory (as :func:`param_spec` is ``init_params``')."""
    return _cache_tree(cfg, batch, seq_len, dtype, torch.device("meta"))


def _whole(path, shape):
    return shape


def _cache_tree(cfg: ModelConfig, batch: int, seq_len: int, dtype, dev, block=_whole) -> dict:
    """The cache, each leaf of ``block(path, whole shape)``'s shape (a
    rank's block under a mesh)."""
    descs, n_groups = block_structure(cfg)
    dt = dtype or cfg.tdtype
    sc = cache_len_for(cfg, seq_len)
    hd = cfg.hd

    def per_layer(j, desc: LayerDesc):
        def zeros(key, shape, dtype):
            return torch.zeros(block(f"l{j}/{key}", shape), dtype=dtype, device=dev)
        c = {}
        if desc.mixer == "attn":
            c["k"] = zeros("k", (n_groups, batch, sc, cfg.n_kv_heads, hd), dt)
            c["v"] = zeros("v", (n_groups, batch, sc, cfg.n_kv_heads, hd), dt)
            c["kv_pos"] = zeros("kv_pos", (n_groups, batch, sc), torch.int32).fill_(-1)
        elif desc.mixer == "mamba":
            di, ds, dc = mamba_mod.d_inner(cfg), cfg.mamba_d_state, cfg.mamba_d_conv
            c["conv"] = zeros("conv", (n_groups, batch, dc - 1, di), torch.float32)
            c["ssm"] = zeros("ssm", (n_groups, batch, di, ds), torch.float32)
        else:  # rwkv
            nh = cfg.d_model // cfg.rwkv_head_dim
            c["tm_prev"] = zeros("tm_prev", (n_groups, batch, cfg.d_model), torch.float32)
            c["cm_prev"] = zeros("cm_prev", (n_groups, batch, cfg.d_model), torch.float32)
            c["wkv"] = zeros("wkv", (n_groups, batch, nh, cfg.rwkv_head_dim, cfg.rwkv_head_dim),
                             torch.float32)
        if desc.cross:
            c["ck"] = zeros("ck", (n_groups, batch, cfg.n_frames, cfg.n_heads, hd), dt)
            c["cv"] = zeros("cv", (n_groups, batch, cfg.n_frames, cfg.n_heads, hd), dt)
        return c

    return {f"l{j}": per_layer(j, d) for j, d in enumerate(descs)}


def _attn_decode(p, h, cfg, cache_l, pos, window, par=None, path="", sc=None):
    """h: (B,1,D); cache_l: {'k','v','kv_pos'} (B,Sc,K,hd), written in place.
    ``pos``: the new token's position, an int, or a (B,) int32 tensor of
    each row's own (``serving.continuous.serve_step_multi``).  Under a plan
    ``par``, ``cache_l`` is this rank's block of a cache of ``sc`` slots,
    and the attention runs as :meth:`parallel.Plan.decode_attend` says."""
    b = h.shape[0]
    hd = cfg.hd
    heads = par is not None and par.heads(path)
    if par is not None and not heads:
        p = par.whole_leaves(p, path)
    q = dense(h, p["wq"], p.get("bq")).reshape(b, 1, -1, hd)
    k = dense(h, p["wk"], p.get("bk")).reshape(b, 1, -1, hd)
    v = dense(h, p["wv"], p.get("bv")).reshape(b, 1, -1, hd)
    if isinstance(pos, int):
        positions, rows = torch.tensor([pos], device=h.device), slice(None)
        q_pos = torch.full((b,), pos, dtype=torch.int32, device=h.device)
    else:
        positions, rows, q_pos = pos[:, None], torch.arange(b, device=h.device), pos
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if par is not None:
        out = par.decode_attend(q, k, v, cache_l, sc, pos, q_pos, window, heads)
        out = out.reshape(b, 1, -1)
        if heads:
            return par.row_sum(out, p["wo"], h.dtype)
        return dense(out, p["wo"])
    # the reference writes slot pos % sc with dynamic_update_slice (a row's
    # own slot with a scatter) into a new cache; the port writes the same
    # slots of the one cache in place
    sc = cache_l["k"].shape[1]
    slot = pos % sc
    cache_l["k"][rows, slot] = k[:, 0]
    cache_l["v"][rows, slot] = v[:, 0]
    cache_l["kv_pos"][rows, slot] = pos
    out = decode_attention(q, cache_l["k"], cache_l["v"], cache_l["kv_pos"], q_pos, window)
    return dense(out.reshape(b, 1, cfg.n_heads * hd), p["wo"])


def apply_layer_decode(p, desc: LayerDesc, x, cfg, cache_l, pos, window, par=None, path="",
                       sc=None):
    """One sublayer over one token; ``cache_l`` (this group's views) is
    updated in place.  ``pos``: an int, or a (B,) tensor (``_attn_decode``).
    ``par``, ``path`` (``layers/l{j}``), ``sc``: a rank's plan under a mesh
    and its cache's slot count; ``cache_l`` then holds the rank's blocks,
    and an RWKV layer all-gathers its ``tm_prev`` and ``cm_prev`` blocks
    into the whole previous rows first."""
    h = _apply_norm(p["norm1"], x, cfg)
    if desc.mixer == "attn":
        att = _attn_decode(p["attn"], h, cfg, cache_l, pos, window, par, f"{path}/attn", sc)
    elif desc.mixer == "mamba":
        att, (conv, ssm) = mamba_mod.mamba_step(
            p["mamba"], h, (cache_l["conv"], cache_l["ssm"]), cfg, par, f"{path}/mamba")
        cache_l["conv"].copy_(conv)
        cache_l["ssm"].copy_(ssm)
    else:
        prev = [cache_l["tm_prev"], cache_l["cm_prev"]]
        n = prev[0].shape[-1]
        if par is not None and n != cfg.d_model:
            prev = par.gather_last_many(prev)
        att, tm_prev, wkv = rwkv_mod.time_mix(p["tm"], h, prev[0].to(h.dtype), cache_l["wkv"],
                                              cfg, par, f"{path}/tm")
        cache_l["tm_prev"].copy_(tm_prev if par is None else par.last_block(tm_prev, n))
        cache_l["wkv"].copy_(wkv)
    x = x + att
    if desc.cross:
        x = x + _cross_decode(p["cross"], _apply_norm(p["norm_cross"], x, cfg), cfg, cache_l,
                              par, f"{path}/cross")
    h = _apply_norm(p["norm2"], x, cfg)
    if desc.ffn == "dense":
        f = _ffn(p["ffn"], h, cfg, par, f"{path}/ffn")
    elif desc.ffn == "moe":
        f, _ = moe_mod.moe_ffn(h, p["ffn"], cfg.moe)
    else:
        f, cm_prev = rwkv_mod.channel_mix(p["cm"], h, prev[1].to(h.dtype), par, f"{path}/cm")
        cache_l["cm_prev"].copy_(cm_prev if par is None else par.last_block(cm_prev, n))
    return x + f


def _cross_decode(p, h, cfg, cache_l, par=None, path=""):
    """One query against every frame of ``cache_l``'s ``ck`` and ``cv``,
    plain ops as in the reference.  Under a plan ``par``, on this rank's
    heads (its ``ck``, ``cv`` blocks) with ``wo``'s rows summed over
    "model", or on the leaves all-gathered where the heads are not whole
    blocks (the cross cache is then replicated)."""
    b, hd = h.shape[0], cfg.hd
    heads = par is not None and par.heads(path)
    if par is not None and not heads:
        p = par.whole_leaves(p, path)
    q = dense(h, p["wq"], p.get("bq")).reshape(b, 1, -1, hd)
    f = cache_l["ck"].shape[1]
    kv_pos = torch.arange(f, dtype=torch.int32, device=h.device).expand(b, f)
    q_pos = torch.full((b,), f, dtype=torch.int32, device=h.device)
    catt = decode_attention(q, cache_l["ck"], cache_l["cv"], kv_pos, q_pos, None)
    catt = catt.reshape(b, 1, -1)
    return par.row_sum(catt, p["wo"], h.dtype) if heads else dense(catt, p["wo"])


def serve_step(params, cfg: ModelConfig, cache: dict, token: torch.Tensor, pos, *,
               mesh=None):
    """One decode step.  token: (B,1) int; pos: the new token's position, an
    int, or a (B,) int32 tensor of each row's own (``_attn_decode``).

    Returns (logits (B,V) f32, cache).  Unlike the reference, which returns
    a new cache, the port updates ``cache`` in place and returns it.

    Under a ``mesh`` (the reference's ``shard_fn=``): ``params`` and
    ``cache`` are this rank's blocks (:func:`init_params`,
    :func:`prefill`), ``token`` and ``pos`` the whole batch's on every rank;
    the rank computes its rows (``rules.batch_specs``) and returns the whole
    (B, V) logits; ``pos`` is an int.
    """
    descs, n_groups = block_structure(cfg)
    if not torch.is_tensor(pos):
        pos = int(pos)
    par, sc, b = _plan(cfg, mesh), None, token.shape[0]
    if par is not None:
        if not isinstance(cache, parallel.ShardedCache):
            raise ValueError("under a mesh the cache is a rank's blocks: make it with "
                             "init_cache(..., mesh=) or prefill(..., mesh=)")
        if torch.is_tensor(pos):
            raise ValueError("under a mesh every row decodes at one position, an int: the "
                             "continuous batcher's per-row positions are not served sharded")
        par.check(token.device)
        lo, hi = par.rows(b)
        token, sc = token[lo:hi], cache.slots
    x = params["embed"][token.long()] if par is None else par.embed(params["embed"], token)
    for g in range(n_groups):
        group_p, cache_g = _group(params["layers"], g), _group(cache, g)
        for j, desc in enumerate(descs):
            x = apply_layer_decode(group_p[f"l{j}"], desc, x, cfg, cache_g[f"l{j}"], pos,
                                   cfg.sliding_window, par, f"layers/l{j}", sc)
    x = _apply_norm(params["final_norm"], x, cfg)
    logits = logits_from_x(params, cfg, x, par=par)[:, 0, :].float()
    if par is not None:
        logits = par.gather_rows(logits, b)
    return logits, cache


def prefill(params, cfg: ModelConfig, batch: dict, cache_seq_len: int, *, mesh=None):
    """Run the full prompt, build a decode cache of ``cache_seq_len`` slots.

    Returns (last-token logits (B,V), cache, next_pos).

    Under a ``mesh`` (the reference's ``shard_fn=``): ``params`` are this
    rank's blocks and ``batch`` the whole batch on every rank; the rank
    runs its rows (``rules.batch_specs``) on its heads and hidden units
    (``parallel.Plan``), the ``flash_attention`` kernel on its local heads,
    and returns the whole logits and its blocks of the cache
    (:func:`init_cache`).
    """
    if mesh is not None:
        return _prefill_sharded(params, cfg, batch, cache_seq_len, _plan(cfg, mesh))
    out = forward(params, cfg, batch, collect_cache=True)
    x = out["x"]
    s_in = x.shape[1]
    logits = logits_from_x(params, cfg, x[:, -1:, :])[:, 0, :]
    raw = out["cache"]
    descs, n_groups = block_structure(cfg)
    cache = init_cache(cfg, x.shape[0], cache_seq_len, device=x.device)
    src_pos, slots = _prefill_slots(cache_len_for(cfg, cache_seq_len), s_in, x.device)
    take = len(src_pos)
    for j, desc in enumerate(descs):
        cj, rj = cache[f"l{j}"], raw[f"l{j}"]
        if desc.mixer == "attn":
            cj["k"][:, :, slots] = rj["k"][:, :, s_in - take:]
            cj["v"][:, :, slots] = rj["v"][:, :, s_in - take:]
            cj["kv_pos"][:, :, slots] = src_pos.to(torch.int32)
        elif desc.mixer == "mamba":
            cj["conv"].copy_(rj["conv"])
            cj["ssm"].copy_(rj["ssm"])
        else:
            cj["tm_prev"].copy_(rj["tm_prev"])
            cj["cm_prev"].copy_(rj["cm_prev"])
            cj["wkv"].copy_(rj["wkv"])
        if desc.cross:
            # the prefill's own tensors, as the reference puts them in (in
            # their dtype, f32 where f32 frames met a bf16 model)
            cj["ck"], cj["cv"] = rj["ck"], rj["cv"]
    return logits, cache, s_in


def _prefill_slots(sc: int, s_in: int, device) -> tuple:
    """The positions a prefill of ``s_in`` keeps in a cache of ``sc``
    slots (its last ``min(sc, s_in)``), and the slot of each."""
    take = min(sc, s_in)
    src_pos = torch.arange(s_in - take, s_in, device=device)
    return src_pos, src_pos % sc


def _prefill_sharded(params, cfg, batch, cache_seq_len, par):
    """:func:`prefill` under ``par``: the encoder first where there is one,
    then a group at a time, each attention layer's k and v sent to the
    ranks whose cache slots they fill (:meth:`parallel.Plan.prefill_kv`) as
    soon as they are made; a recurrent layer's states and a cross layer's
    k and v are the rank's blocks as computed (``tm_prev`` and ``cm_prev``
    narrowed to its d_model block)."""
    b = batch["tokens"].shape[0]
    par.check(batch["tokens"].device)
    lo, hi = par.rows(b)
    mine = {k: v[lo:hi] for k, v in batch.items()}
    x, positions, _ = embed_inputs(params, cfg, mine, par=par)
    enc_out = (_encoder(params, cfg, mine["frames"], par=par) if cfg.family == "encdec"
               else None)
    s_in = x.shape[1]
    cache = init_cache(cfg, b, cache_seq_len, device=x.device, mesh=par.mesh)
    src_pos, slots = _prefill_slots(cache.slots, s_in, x.device)
    descs, n_groups = block_structure(cfg)
    cross = {j: [] for j, desc in enumerate(descs) if desc.cross}
    for g, group_p in enumerate(_groups(params["layers"], n_groups)):
        cache_g = _group(cache, g)
        for j, desc in enumerate(descs):
            path = f"layers/l{j}"
            x, _, c = apply_layer_seq(group_p[f"l{j}"], desc, x, cfg, positions,
                                      window=cfg.sliding_window, enc_out=enc_out,
                                      collect_cache=True, par=par, path=path)
            cj = cache_g[f"l{j}"]
            if desc.mixer == "attn":
                k, v, kv_pos = par.prefill_kv(c.pop("k"), c.pop("v"), src_pos, slots,
                                              cache.slots, par.heads(f"{path}/attn"))
                cj["k"].copy_(k)
                cj["v"].copy_(v)
                cj["kv_pos"].copy_(kv_pos.expand_as(cj["kv_pos"]))
            elif desc.mixer == "mamba":
                cj["conv"].copy_(c["conv"])
                cj["ssm"].copy_(c["ssm"])
            else:
                for key in ("tm_prev", "cm_prev"):
                    cj[key].copy_(par.last_block(c[key], cj[key].shape[-1]))
                cj["wkv"].copy_(c["wkv"])
            if desc.cross:
                cross[j].append((c["ck"], c["cv"]))
    # the prefill's own tensors, as the one-process prefill puts them in
    for j, kvs in cross.items():
        cache[f"l{j}"]["ck"], cache[f"l{j}"]["cv"] = (torch.stack(t) for t in zip(*kvs))
    x = _apply_norm(params["final_norm"], x, cfg)
    logits = logits_from_x(params, cfg, x[:, -1:, :], par=par)[:, 0, :]
    return par.gather_rows(logits, b), cache, s_in
