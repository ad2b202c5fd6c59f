"""How a rank serves on its blocks of the inference profile (port-only: the
reference leaves this to GSPMD).

The reference serves over a mesh by handing ``jax.jit`` the weights placed
by ``rules.param_specs(..., profile="inference")`` (weights over "model"
only), the decode cache placed by ``rules.cache_specs`` (rows over "data",
cache slots over "model"), the batch by ``rules.batch_specs`` and a
``shard_fn``; XLA inserts the collectives.  The port keeps on each rank
only its blocks (``sharding/blocks.py``), and a :class:`Plan` answers, leaf
by leaf, how the rank computes on them, with explicit collectives on the
mesh's "model" group:

* a column block (``attn/w[qkv]``, ``attn/b[qkv]``, ``ffn/w_(gate|up)``,
  ``embed``, ``head``, ``projector/w[12]``): the rank computes its columns;
* a row block (``attn/wo``, ``ffn/w_down``, and ``embed`` as a tied head):
  the rank computes a partial sum over its rows, summed over "model" in f32
  and cast once (``blocks.sum_f32``);
* a replicated leaf (the rules' ``_sanitize`` dropped the axis, as where
  ``d_ff % model`` is nonzero): the rank computes it whole, with no
  collective;
* a misaligned block: q/k/v columns that are not whole heads (``H`` or
  ``K`` not a multiple of "model", where ``_sanitize`` still cuts ``K·hd``
  mid-head), or an RWKV time-mix whose ``w[rkvg]`` columns are not whole
  heads: the rank all-gathers that layer's attention (or time-mix) leaves
  (``blocks.gather_full``, counted in ``blocks.traffic``) and runs it whole.

The recurrent and encoder-decoder families split the same way:

* RWKV time-mix (:meth:`Plan.tm_heads`): ``w[rkvg]`` are column blocks of
  whole heads, ``wo`` a row block, every other leaf replicated; the rank
  runs ``_ddlerp`` whole, r, k, v, g on its columns, the decay, the bonus
  and ``ln_x`` narrowed to its heads, ``rwkv6_scan`` on its heads from its
  block of the ``wkv`` state, and sums ``wo``'s rows.  Channel-mix:
  ``w_k``'s columns and ``w_v``'s rows make the hidden product a row sum;
  ``w_r``'s columns are all-gathered (``sigmoid`` of the whole).
  ``tm_prev`` and ``cm_prev`` hold the rank's d_model block, as
  ``cache_specs`` places them; ``_ddlerp`` and ``w_k`` need the whole
  previous row, so a decode step all-gathers both (:meth:`Plan.gather_last_many`).
* Mamba (:meth:`Plan.mamba_split`): ``in_proj`` is a column block of the
  concatenated (x, z) output, so a rank's columns are not its channels' x
  and z; one all-to-all over "model" (:meth:`Plan.mamba_xz`) gives each
  rank the x and z of its ``d_inner / model`` channels, on which every
  channel leaf, the ``conv`` and ``ssm`` cache blocks and ``mamba_scan``
  run; ``x_proj`` and ``out_proj`` are row blocks, summed in f32 (the
  former before its split into dt, B and C).
* The GELU MLP: ``w_in``, ``b_in`` columns, ``w_out`` rows summed, then
  the replicated ``b_out`` added once.
* Cross-attention: the rank's heads where they are whole (its ``ck``,
  ``cv`` blocks are the heads it computes), else gathered whole as
  self-attention is; the encoder's ``enc/proj`` and ``enc/pos`` column
  blocks are all-gathered, its layers split as the decoder's.

The residual stream stays whole on every rank of a "model" group: the
column products that feed it (``embed``'s lookup, the projector's, ``head``'s
vocab columns) are all-gathered over "model", and the row products summed.
Rows go over "data" as ``batch_specs`` places them (every rank takes them
all where they do not divide), and the logits are all-gathered over "data",
so every rank returns the whole (B, V).

The decode cache holds this rank's rows and its block of slots for every kv
head.  The prefill's k and v come out of the attention by heads; an
all-to-all over "model" sends each rank its slots for every head.  A decode
step all-gathers the new token's q, k and v over "model", the rank whose
block holds slot ``pos % Sc`` writes it, each rank attends over its slots
(``layers.decode_attention_partial``), and an all-to-all brings each rank
every rank's partial for its own heads, which ``layers.combine`` merges as
one softmax over every slot.  Where ``Sc % model`` is nonzero the slot axis
is replicated: every rank writes every slot and attends over all of them
with its own heads, and nothing is combined, so no slot counts twice.

MoE is refused (:func:`refuse`).
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from repro_torch.models.layers import combine, decode_attention, decode_attention_partial, dense
from repro_torch.sharding import blocks
from repro_torch.sharding import rules as R
from repro_torch.tree import tree_leaves, tree_map

def refuse(cfg) -> None:
    """``NotImplementedError`` naming its ROADMAP item for a config that
    sharded serving does not take: an MoE one."""
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE serving under a mesh (ROADMAP A14d3): experts over 'model' "
            "come after MoE training under a mesh (A14b2); serve it in one process")


def check_backend(backend: str, device) -> None:
    """``ValueError`` where ``nccl`` would carry tensors off the card."""
    if backend == "nccl" and torch.device(device).type != "cuda":
        raise ValueError(f"nccl carries CUDA tensors only; the tensors are on {device}: start "
                         "the group with backend='gloo' to serve on the CPU")


def _row_partial(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in f32: on the card a bf16 or f16 product accumulates in
    f32 and is not rounded (cuBLAS's ``out_dtype``), elsewhere the product
    in its dtype, then f32.  Mixed operands (a bf16 model's encoder fed f32
    frames) are promoted first, as ``layers.dense`` promotes them."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.view(*x.shape[:-1], w.shape[-1])
    return (x @ w).float()


class Plan:
    """A rank's way through a served model on ``mesh``, a ("data",
    "model") ``DeviceMesh``, given ``specs``, the inference profile's
    ``param_specs`` of the whole tree.  Built once for each config and
    mesh (``transformer._plan``); it holds no tensor."""

    def __init__(self, cfg, mesh, specs):
        refuse(cfg)
        names, shape = R.mesh_axes(mesh)
        if tuple(names) != ("data", "model"):
            raise ValueError(f"sharded serving takes a ('data', 'model') mesh, not {names}")
        self.cfg, self.mesh, self.specs = cfg, mesh, specs
        self.dp, self.m = shape
        coords = blocks.coordinates(mesh)
        self.di, self.r = coords["data"], coords["model"]
        # the dim "model" cuts in each leaf, counted from the end (-1 its
        # columns, -2 a 2-D leaf's rows), the group axis left out; None where
        # the leaf is replicated
        self._cut = {}

        def one(path, spec):
            p = "/".join(map(str, path))
            stacked = p.startswith("layers/") or "/layers/" in p
            entries = tuple(spec)[1:] if stacked else tuple(spec)
            self._cut[p] = next((d - len(entries) for d, e in enumerate(entries)
                                 if "model" in R._axes(e)), None)
        R._map_with_path(one, specs)

    @functools.cached_property
    def group(self):
        """The process group of this rank's "model" axis (``None`` on one)."""
        return self.mesh.get_group("model") if self.m > 1 else None

    @functools.cached_property
    def data_group(self):
        return self.mesh.get_group("data") if self.dp > 1 else None

    def check(self, device) -> None:
        """:func:`check_backend` of the mesh's groups for tensors on ``device``."""
        group = self.group or self.data_group
        if group is not None:
            check_backend(dist.get_backend(group), device)

    # ------------------------------------------------------------ leaves ----
    def _split(self, path: str, cols=(), rows=()) -> bool:
        """Whether "model" (of more than one rank) cuts each leaf ``cols``
        under ``path`` by its columns (a bias: its one dim) and each of
        ``rows`` by its rows."""
        cut = self._cut
        return (self.m > 1 and all(cut[f"{path}/{k}"] == -1 for k in cols)
                and all(cut[f"{path}/{k}"] == -2 for k in rows))

    def heads(self, path: str) -> bool:
        """Whether the attention at ``path`` (``layers/l{j}/attn``,
        ``layers/l{j}/cross``, ``enc/layers/attn``) splits into whole
        heads: q, k, v (and their biases) cut by columns into whole heads,
        ``wo`` by rows.  Else it runs whole (:meth:`whole_leaves`)."""
        cfg, m = self.cfg, self.m
        kv = cfg.n_heads if path.endswith("cross") else cfg.n_kv_heads
        if m == 1 or cfg.n_heads % m or kv % m:
            return False
        bias = [f"b{x}" for x in "qkv" if f"{path}/b{x}" in self._cut]
        return self._split(path, cols=["wq", "wk", "wv"] + bias, rows=["wo"])

    def ffn_split(self, path: str) -> bool:
        """Whether the FFN at ``path`` splits its hidden units: the SwiGLU's
        gate and up (the GELU MLP's ``w_in`` and ``b_in``, RWKV channel-mix's
        ``w_k``) by columns, its down (``w_out``, ``w_v``) by rows."""
        for cols, rows in ((["w_gate", "w_up"], ["w_down"]), (["w_in", "b_in"], ["w_out"]),
                           (["w_k"], ["w_v"])):
            if f"{path}/{rows[0]}" in self._cut:
                return self._split(path, cols, rows)
        raise KeyError(f"{path}: no FFN leaves")

    def tm_heads(self, path: str) -> bool:
        """Whether the RWKV time-mix at ``path`` (``layers/l{j}/tm``) splits
        into whole heads: ``w[rkvg]`` by columns, ``wo`` by rows, and the
        head count a multiple of "model" (as the ``wkv`` cache's heads)."""
        cfg = self.cfg
        if (cfg.d_model // cfg.rwkv_head_dim) % self.m:
            return False
        return self._split(path, cols=["wr", "wk", "wv", "wg"], rows=["wo"])

    def mamba_split(self, path: str) -> bool:
        """Whether the Mamba mixer at ``path`` (``layers/l{j}/mamba``)
        splits by channel: every channel leaf cut over "model", as the
        ``conv`` and ``ssm`` cache blocks are."""
        return self._split(path, cols=["in_proj", "conv", "conv_b", "dt_proj", "dt_bias", "D"],
                           rows=["x_proj", "A_log", "out_proj"])

    def whole_leaves(self, tree: dict, path: str) -> dict:
        """The group's leaves of ``tree``, the sub-nest at ``path`` under
        ``layers``, whole: the cut ones all-gathered over "model" together
        (``blocks.gather_full``)."""
        specs = blocks.specs_at(self.specs, path)
        it = iter(blocks.gather_full(tree_leaves(tree), specs, self.mesh))
        return tree_map(lambda _: next(it), tree)

    # ---------------------------------------------------------- products ----
    def gather_last(self, y: torch.Tensor) -> torch.Tensor:
        """The whole of ``y``, whose last dim the "model" ranks split."""
        return blocks.all_gather_last(y, self.group, self.m)

    def gather_last_many(self, ts: list) -> list:
        """The whole of each of ``ts``, whose last dims the "model" ranks
        split, in one all-gather (one dtype)."""
        if self.m == 1:
            return list(ts)
        widths = [t.shape[-1] for t in ts]
        got = blocks.all_gather(torch.cat(ts, -1), self.group, self.m)     # (m, ..., sum)
        return [p.movedim(0, -2).reshape(*p.shape[1:-1], self.m * n)
                for p, n in zip(got.split(widths, -1), widths)]

    def last_block(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """This rank's block of ``n`` of ``t``'s last dim (``t`` itself where
        ``n`` is all of it): a recurrent cache's d_model block."""
        return t if n == t.shape[-1] else t.narrow(-1, self.r * n, n)

    def mamba_xz(self, xz: torch.Tensor) -> tuple:
        """``(x, z)`` of this rank's channels from its column block ``xz``
        (..., 2n) of ``in_proj``'s concatenated (x, z) output.  The output's
        2·model blocks of n columns are x's channel blocks, then z's; rank i
        holds blocks 2i and 2i + 1, so it sends each to the rank whose
        channels it holds (block q to rank q % model) in one all-to-all of
        n-column parts (zeros where it holds nothing for a rank), and takes
        its x from rank r // 2 and its z from rank (model + r) // 2."""
        m, r = self.m, self.r
        n = xz.shape[-1] // 2
        parts = xz.new_zeros((m,) + xz.shape[:-1] + (n,))
        for t in range(2):
            parts[(2 * r + t) % m] = xz[..., t * n:(t + 1) * n]
        got = blocks.all_to_all(parts, self.group, m)
        return got[r // 2], got[(m + r) // 2]

    def row_sum(self, h: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
        """``h @ w`` over the rows of ``w`` this rank holds, summed over
        "model" in f32, cast to ``dtype`` once."""
        return blocks.sum_f32(_row_partial(h, w), self.group, self.m, dtype)

    def whole(self, x, w, b, wpath: str, bpath: str) -> torch.Tensor:
        """``dense(x, w, b)`` whole from this rank's column block of ``w``
        (``b`` cut alike, or whole and narrowed here), all-gathered over
        "model"; from ``w`` whole where the rules left it so."""
        if self._cut[wpath] != -1:
            return dense(x, w, b)
        n = w.shape[-1]
        if b is not None and self._cut[bpath] is None:
            b = b.narrow(-1, self.r * n, n)
        return self.gather_last(dense(x, w, b))

    def embed(self, emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The embedding rows of ``tokens`` from this rank's d_model block
        of ``embed``, all-gathered over "model"."""
        x = emb[tokens.long()]
        return self.gather_last(x) if self._cut["embed"] == -1 else x

    def logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """``x @ head`` whole: ``head``'s vocab columns all-gathered, or a
        tied ``embed``'s d_model block (rows of ``embed.T``) summed."""
        if self.cfg.tie_embeddings:
            emb = params["embed"]
            if self._cut["embed"] == -1:
                k = emb.shape[1]
                return self.row_sum(x.narrow(-1, self.r * k, k), emb.T, x.dtype)
            return x @ emb.T
        return self.whole(x, params["head"], None, "head", "")

    # -------------------------------------------------------------- rows ----
    def _rows_split(self, b: int) -> bool:
        return self.dp > 1 and b % self.dp == 0

    def rows(self, b: int) -> tuple:
        """``(start, stop)``: the batch rows this rank computes, as
        ``batch_specs`` (and ``cache_specs``) place them."""
        if not self._rows_split(b):
            return 0, b
        n = b // self.dp
        return self.di * n, (self.di + 1) * n

    def gather_rows(self, t: torch.Tensor, b: int) -> torch.Tensor:
        """The whole batch's ``t`` from every data shard's rows."""
        if not self._rows_split(b):
            return t
        return blocks.all_gather(t, self.data_group, self.dp).reshape(b, *t.shape[1:])

    # ------------------------------------------------------------- cache ----
    def slots(self, sc: int) -> tuple:
        """``(start, count, cut)``: this rank's block of ``sc`` cache slots,
        and whether "model" cuts the slot axis (``cache_specs``)."""
        if self.m > 1 and sc % self.m == 0:
            n = sc // self.m
            return self.r * n, n, True
        return 0, sc, False

    def prefill_kv(self, k, v, src_pos, idx, sc: int, heads: bool) -> tuple:
        """``(k, v, kv_pos)`` of this rank's block of a cache of ``sc``
        slots after a prefill that keeps positions ``src_pos`` in slots
        ``idx``: k and v (B, slots, K, hd), kv_pos (slots,).  ``k``, ``v``
        (B, S, Kr, hd) hold this rank's kv heads where ``heads``, else every
        head."""
        b, kr, hd = k.shape[0], k.shape[2], k.shape[3]
        take = len(src_pos)
        kv = k.new_zeros((2, b, sc, kr, hd))
        kv[0][:, idx] = k[:, k.shape[1] - take:]
        kv[1][:, idx] = v[:, v.shape[1] - take:]
        lo, n, cut = self.slots(sc)
        if heads and cut:
            # part j: my heads at rank j's slots; back: every rank's heads at mine
            got = blocks.all_to_all(kv.view(2, b, self.m, n, kr, hd).movedim(2, 0),
                                    self.group, self.m)
            kv = got.movedim(0, 3).reshape(2, b, n, self.m * kr, hd)
        elif heads:
            got = blocks.all_gather(kv, self.group, self.m)
            kv = got.movedim(0, 3).reshape(2, b, sc, self.m * kr, hd)
        else:
            kv = kv[:, :, lo:lo + n]
        pos = torch.full((sc,), -1, dtype=torch.int32, device=k.device)
        pos[idx] = src_pos.to(torch.int32)
        return kv[0], kv[1], pos[lo:lo + n]

    def decode_attend(self, q, k, v, cache_l: dict, sc: int, pos: int, q_pos, window,
                      heads: bool):
        """One token's attention at position ``pos`` over the cache block
        ``cache_l`` of a cache of ``sc`` slots (written in place): q
        (B,1,Hr,hd), k, v (B,1,Kr,hd) after rope, this rank's heads where
        ``heads``, else every head.  Returns (B,1,Hr,hd) in q's dtype, for
        the same heads as ``q``."""
        b, _, hr, hd = q.shape
        lo, n, cut = self.slots(sc)
        q_all, k_all, v_all = q, k, v
        if heads:
            parts = ([q] if cut else []) + [k, v]
            got = blocks.all_gather(torch.cat([t.reshape(b, -1) for t in parts], -1),
                                    self.group, self.m)
            sizes = [t[0, 0].numel() for t in parts]
            full = [x.movedim(0, 1).reshape(b, 1, -1, hd)
                    for x in got.split(sizes, dim=-1)]
            if cut:
                q_all, k_all, v_all = full
            else:
                k_all, v_all = full
        slot = pos % sc
        if lo <= slot < lo + n:
            cache_l["k"][:, slot - lo] = k_all[:, 0]
            cache_l["v"][:, slot - lo] = v_all[:, 0]
            cache_l["kv_pos"][:, slot - lo] = pos
        if not cut:
            kc, vc = cache_l["k"], cache_l["v"]
            if heads:
                kr = k.shape[2]
                kc, vc = (t.narrow(2, self.r * kr, kr) for t in (kc, vc))
            return decode_attention(q, kc, vc, cache_l["kv_pos"], q_pos, window)
        out, lse = decode_attention_partial(q_all, cache_l["k"], cache_l["v"],
                                            cache_l["kv_pos"], q_pos, window)
        part = torch.cat([out[:, 0], lse[..., None]], -1)          # (B, H, hd + 1)
        if heads:
            got = blocks.all_to_all(part.view(b, self.m, hr, hd + 1).movedim(1, 0),
                                    self.group, self.m)
        else:
            got = blocks.all_gather(part, self.group, self.m)
        return combine(got[..., :hd], got[..., hd])[:, None].to(q.dtype)


class ShardedCache(dict):
    """A rank's blocks of a decode cache under ``cache_specs``, the nest of
    ``transformer.init_cache``, with the whole cache's slot count
    ``slots``, which the blocks alone do not tell (a block of ``Sc / model``
    slots and a replicated ``Sc`` can have the same length)."""

    def __init__(self, tree: dict, slots: int):
        super().__init__(tree)
        self.slots = slots
