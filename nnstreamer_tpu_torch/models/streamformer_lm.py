"""StreamFormer LM serving: full-sequence forward + KV-cache decoding.

The PyTorch counterpart of ``nnstreamer_tpu/models/streamformer_lm.py``,
over the same parameter tree (``parallel/train_step.py``) kept as a plain
dict of tensors:

- :func:`forward_logits` — the full-sequence forward, the registry model
  ``streamformer_lm`` behind ``tensor_filter framework=xla``;
- :func:`prefill_kv` — the same forward returning every layer's K/V, the
  decode tier's prompt prefill; both run causal attention through the
  hand-written flash kernel for tensors on the card;
- :func:`decode_step_pooled` — one continuous-batching step over a slot
  pool, updating the pool **in place** (the JAX package donates the
  pool into its executable; here the scatter writes into it);
- :func:`decode_step_paged` / :func:`prefill_chunk_paged` — the same
  step, and one bounded prompt chunk, over the block-paged arena of
  ``llm/paged.py``, written in place; no host sync inside, so each runs
  as one CUDA graph per padded shape;
- :func:`decode_step` / :func:`generate` — the single-sequence cache and
  an eager greedy/sampled loop, in place of the ``lax.scan``.

Numerics kept from the JAX package: the bias-free ``_ln`` in f32, matmuls
in ``cfg.dtype``, the embedding sum, the router and the head in f32, and
``jax.nn.gelu``'s tanh approximation.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, parse_dtype, resolve_device
from ..parallel.train_step import StreamFormerConfig, _ln, init_params

#: leaves used in ``cfg.dtype`` (the JAX package casts them at each use;
#: :func:`place_params` casts them once)
_COMPUTE_LEAVES = ("wqkv", "wo", "w1", "w2", "we1", "we2")


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


def place_params(params: Mapping[str, Any], cfg: StreamFormerConfig,
                 device: DeviceLike = None) -> Dict[str, Any]:
    """The tree on ``device`` (``None``: the card): the matmul weights in
    ``cfg.dtype`` (cast once here instead of at every use, the same
    values), the embeddings, norms, router and head in f32."""
    device = resolve_device(device)

    def put(x, dtype=torch.float32):
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(np.asarray(x, dtype=np.float32))
        return x.to(device=device, dtype=dtype)

    return {
        **{n: put(params[n]) for n in ("embed", "pos", "head", "ln_f")},
        "layers": [{n: put(w, cfg.dtype if n in _COMPUTE_LEAVES
                           else torch.float32) for n, w in lyr.items()}
                   for lyr in params["layers"]],
    }


#: the JAX package's parameter tree (numpy or jax arrays) as the port's:
#: the same names and layouts, so only a dtype and device move
params_from_jax = place_params


def _moe_dense(y: torch.Tensor, lyr: Mapping[str, torch.Tensor],
               cfg: StreamFormerConfig) -> torch.Tensor:
    """Top-1 routed MoE for serving: per-token expert choice, a dense
    product over ALL experts masked to the chosen one (E is small; no
    capacity cap at serving — every token runs its expert)."""
    gate = y.float() @ lyr["gate"].float()
    probs = torch.softmax(gate, dim=-1)
    choice = torch.argmax(probs, dim=-1)
    onehot = F.one_hot(choice, cfg.experts).to(y.dtype)
    scale = torch.gather(probs, -1, choice[..., None])[..., 0].to(y.dtype)
    h = _gelu(torch.einsum("...d,edf->...ef", y, lyr["we1"].to(y.dtype)))
    out = torch.einsum("...ef,efd->...ed", h, lyr["we2"].to(y.dtype))
    picked = torch.einsum("...ed,...e->...d", out, onehot)
    return picked * scale[..., None]


def _mlp_residual(x, lyr, cfg):
    """The layer's second half: x + MLP(ln2 x) + MoE(ln2 x)."""
    dt = cfg.dtype
    y = _ln(x.float(), lyr["ln2"]).to(dt)
    m = _gelu(y @ lyr["w1"].to(dt)) @ lyr["w2"].to(dt)
    return x + m + _moe_dense(y, lyr, cfg)


def _qkv(x, lyr, cfg):
    """(..., D) → q, k, v (..., H, Dh) views of one fused projection."""
    y = _ln(x.float(), lyr["ln1"]).to(cfg.dtype)
    w = lyr["wqkv"].to(cfg.dtype)
    qkv = (y @ w.reshape(w.shape[0], -1)).reshape(
        *y.shape[:-1], 3, cfg.heads, cfg.head_dim)
    return qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]


def _out_proj(attn, lyr, cfg):
    """(..., H, Dh) → (..., D)."""
    wo = lyr["wo"].to(cfg.dtype)
    return attn.to(cfg.dtype).flatten(-2) @ wo.reshape(-1, wo.shape[-1])


def _embed(params, tokens, pos, cfg):
    return (params["embed"][tokens] + params["pos"][pos]).to(cfg.dtype)


def _prefill(params, tokens, cfg, flash, keep_kv: bool):
    t = tokens.shape[-1]
    if flash is None:
        from ..ops.flash_attention import flash_wins

        flash = flash_wins(t, params["embed"])
    tokens = tokens.long()
    x = _embed(params, tokens, torch.arange(t, device=tokens.device), cfg)
    ks, vs = [], []
    for lyr in params["layers"]:
        q, k, v = _qkv(x, lyr, cfg)
        if keep_kv:
            ks.append(k)
            vs.append(v)
        if flash:
            from ..ops.flash_attention import flash_attention

            attn = flash_attention(q, k, v, causal=True)
        else:
            from ..parallel.ring_attention import local_attention

            attn = local_attention(q, k, v, causal=True)
        x = _mlp_residual(x + _out_proj(attn, lyr, cfg), lyr, cfg)
    logits = _ln(x.float(), params["ln_f"]) @ params["head"]
    return logits, ks, vs


def forward_logits(params: Dict[str, Any], tokens: torch.Tensor,
                   cfg: StreamFormerConfig,
                   flash: Optional[bool] = None) -> torch.Tensor:
    """Full-sequence forward: tokens ``([B,] T)`` int → logits ``([B,] T,
    vocab)`` f32; a batch runs each attention layer as one launch with
    the batch in its grid.

    ``flash``: causal attention through the flash kernel; ``None`` lets
    :func:`~..ops.flash_attention.flash_wins` pick (the kernel on the
    card, plain attention off it)."""
    return _prefill(params, tokens, cfg, flash, keep_kv=False)[0]


def prefill_kv(params: Dict[str, Any], tokens: torch.Tensor,
               cfg: StreamFormerConfig, flash: Optional[bool] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-prompt prefill for the KV-cache serving tier: the
    :func:`forward_logits` math that also returns every layer's keys and
    values — ``tokens (T,) → (logits (T, vocab) f32, k (L, T, H, Dh),
    v (L, T, H, Dh))`` in ``cfg.dtype``.  Continuing it through
    :func:`decode_step_pooled` gives the logits of decoding the whole
    prompt step by step."""
    logits, ks, vs = _prefill(params, tokens, cfg, flash, keep_kv=True)
    return logits, torch.stack(ks), torch.stack(vs)


def decode_step_pooled(params: Dict[str, Any], k_pool: torch.Tensor,
                       v_pool: torch.Tensor, tokens: torch.Tensor,
                       pos: torch.Tensor, slots: torch.Tensor,
                       cfg: StreamFormerConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One continuous-batching decode step over a slot-pooled cache.

    - ``k_pool``/``v_pool``: ``(S, L, max_seq, H, Dh)``, the session
      pool's cache; this step's K/V are written into them **in place**
      (no copy of the pool) and they are returned for parity;
    - ``tokens``/``pos``/``slots``: ``(B,)`` int — each lane's token,
      position and cache slot.  Padding lanes point at a scratch slot;
    - returns ``(logits (B, vocab) f32, k_pool, v_pool)``.

    Lane *i* equals a solo :func:`decode_step` on slot *i*'s cache:
    attention covers the slot's positions ``<= pos``, in f32 plain
    attention, as in the JAX package."""
    tokens, pos, slots = tokens.long(), pos.long(), slots.long()
    x = _embed(params, tokens, pos, cfg)
    valid = torch.arange(cfg.max_seq, device=pos.device)[None, :] \
        <= pos[:, None]                                       # (B, T)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    for li, lyr in enumerate(params["layers"]):
        q, k, v = _qkv(x, lyr, cfg)                           # (B, H, Dh)
        k_pool[slots, li, pos] = k
        v_pool[slots, li, pos] = v
        kcur = k_pool[slots, li]                       # (B, max_seq, H, Dh)
        vcur = v_pool[slots, li]
        s = torch.einsum("bhd,bthd->bht", q.float(), kcur.float()) * scale
        s = s.masked_fill(~valid[:, None, :], float("-inf"))
        p = torch.softmax(s, dim=-1)
        attn = torch.einsum("bht,bthd->bhd", p, vcur.float())
        x = _mlp_residual(x + _out_proj(attn, lyr, cfg), lyr, cfg)
    logits = _ln(x.float(), params["ln_f"]) @ params["head"]
    return logits, k_pool, v_pool


def _attend(q, kcur, vcur, valid, scale, lanes: str):
    """Plain masked attention in f32: ``q (Q, H, Dh)`` against
    ``kcur``/``vcur`` (``lanes="q"``: one ``(T, H, Dh)`` run per query,
    ``""``: one run shared by every query), ``valid (Q, T)``."""
    s = torch.einsum(f"qhd,{lanes}thd->qht", q.float(), kcur.float()) * scale
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum(f"qht,{lanes}thd->qhd", p, vcur.float())


def decode_step_paged(params: Dict[str, Any], k_pages: torch.Tensor,
                      v_pages: torch.Tensor, tokens: torch.Tensor,
                      pos: torch.Tensor, tables: torch.Tensor,
                      cfg: StreamFormerConfig, page_size: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One continuous-batching decode step over a block-paged cache (the
    vLLM/PagedAttention layout: a session's cache is a chain of
    fixed-size pages named by a block table).

    - ``k_pages``/``v_pages``: ``(P, L, page_size, H, Dh)``, one arena
      shared by every session, the last page the caller's scratch page;
      this step's K/V are written into them **in place** (the JAX
      package donates the arena) and they are returned for parity;
    - ``tokens``/``pos``: ``(B,)`` int per lane;
    - ``tables``: ``(B, W)`` int — each lane's block table, page ``j``
      holding positions ``[j*page_size, (j+1)*page_size)``, with
      ``W*page_size > max(pos)``; entries past a lane's pages and every
      entry of a padding lane point at the scratch page;
    - returns ``(logits (B, vocab) f32, k_pages, v_pages)``.

    Per layer: append the new K/V into the tail page (``tables[b,
    pos//page_size]`` at offset ``pos % page_size``), gather the lane's
    pages back as one ``W*page_size`` run and attend with the dense
    step's causal-prefix mask.  Nothing here reads a value back to the
    host, so one CUDA graph serves every lane content."""
    ps = int(page_size)
    b, w = tables.shape
    span = w * ps
    tokens, pos, tables = tokens.long(), pos.long(), tables.long()
    x = _embed(params, tokens, pos, cfg)
    valid = torch.arange(span, device=pos.device)[None, :] \
        <= pos[:, None]                                       # (B, W*ps)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    # tail-page coordinates of this step's append
    wpage = torch.gather(tables, 1, (pos // ps)[:, None])[:, 0]
    woff = pos % ps
    for li, lyr in enumerate(params["layers"]):
        q, k, v = _qkv(x, lyr, cfg)                           # (B, H, Dh)
        k_pages[wpage, li, woff] = k
        v_pages[wpage, li, woff] = v
        kcur = k_pages[tables, li].reshape(b, span, cfg.heads, cfg.head_dim)
        vcur = v_pages[tables, li].reshape(b, span, cfg.heads, cfg.head_dim)
        attn = _attend(q, kcur, vcur, valid, scale, "q")
        x = _mlp_residual(x + _out_proj(attn, lyr, cfg), lyr, cfg)
    logits = _ln(x.float(), params["ln_f"]) @ params["head"]
    return logits, k_pages, v_pages


def prefill_chunk_paged(params: Dict[str, Any], k_pages: torch.Tensor,
                        v_pages: torch.Tensor, tokens: torch.Tensor,
                        table: torch.Tensor, start: torch.Tensor,
                        true_len: torch.Tensor, cfg: StreamFormerConfig,
                        page_size: int, scratch: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One bounded prefill chunk of a paged session: ``C`` prompt tokens
    from absolute position ``start``, written into the session's pages
    and attending over what the pages already hold (a shared prefix,
    earlier chunks) plus the chunk itself, causally, so chaining chunks
    gives the whole-prompt prefill's math.

    - ``tokens (C,)`` int: the chunk, zero-padded past ``true_len``;
    - ``table (W,)`` int: the session's block table, scratch-padded,
      ``W*page_size >= start + true_len``;
    - ``start``, ``true_len``, ``scratch``: 0-d or ``(1,)`` int device
      tensors — the chunk's origin, its real length and the arena's
      scratch page; being operands, not constants, one CUDA graph per
      ``(C, W)`` serves every chunk of every prompt at every offset;
    - returns ``(last_logits (vocab,) f32, k_pages, v_pages)``, the row of
      position ``start + true_len - 1``, the pages written in place.

    Padding queries write into the scratch page.  Where a padding query's
    position runs past the table or the position embedding, its index is
    clamped to the last entry (the JAX package's out-of-range gather
    clamps the same way); its row is never read."""
    ps = int(page_size)
    c = tokens.shape[0]
    w = table.shape[0]
    span = w * ps
    dev = tokens.device
    tokens, table = tokens.long(), table.long()
    start, true_len = start.long().reshape(()), true_len.long().reshape(())
    ar = torch.arange(c, device=dev)
    qpos = start + ar                                         # (C,)
    qvalid = ar < true_len
    x = _embed(params, tokens, qpos.clamp(max=cfg.max_seq - 1), cfg)
    # key position t is visible to chunk query i iff t <= start + i
    kvalid = torch.arange(span, device=dev)[None, :] <= qpos[:, None]
    wpage = torch.where(qvalid, table[(qpos // ps).clamp(max=w - 1)],
                        scratch.long().reshape(()))           # (C,)
    woff = qpos % ps
    scale = 1.0 / math.sqrt(cfg.head_dim)
    for li, lyr in enumerate(params["layers"]):
        q, k, v = _qkv(x, lyr, cfg)                           # (C, H, Dh)
        k_pages[wpage, li, woff] = k
        v_pages[wpage, li, woff] = v
        kcur = k_pages[table, li].reshape(span, cfg.heads, cfg.head_dim)
        vcur = v_pages[table, li].reshape(span, cfg.heads, cfg.head_dim)
        attn = _attend(q, kcur, vcur, kvalid, scale, "")
        x = _mlp_residual(x + _out_proj(attn, lyr, cfg), lyr, cfg)
    logits = _ln(x.float(), params["ln_f"]) @ params["head"]
    last = logits.index_select(0, (true_len - 1).reshape(1))[0]
    return last, k_pages, v_pages


def config_from_custom(custom: Mapping[str, Any], default_seq: int = 64,
                       device: DeviceLike = None) -> StreamFormerConfig:
    """The ``custom=`` sizing grammar shared by the registry filter and
    the LLM serving tier::

        custom=layers:8,width:512,heads:8,head_dim:64,max_seq:1024

    Keys: ``vocab`` ``dim``/``width`` (aliases) ``heads`` ``head_dim``
    ``mlp`` ``layers`` ``experts`` ``max_seq`` ``dtype`` (``seq`` and
    ``seed`` stay with their callers).  ``max_seq`` defaults to
    ``max(seq, 64)``.  ``dtype`` defaults to bf16, or to the device's
    default (:func:`~..device.default_dtype`) when ``device`` is given."""
    if "dim" in custom and "width" in custom \
            and str(custom["dim"]) != str(custom["width"]):
        raise ValueError("streamformer_lm: custom dim and width are "
                         "aliases; give one")
    seq = int(custom["seq"]) if "seq" in custom else int(default_seq)
    name = custom.get("dtype") or (None if device is not None
                                   else "bfloat16")
    cfg = StreamFormerConfig(
        vocab=int(custom.get("vocab", 256)),
        dim=int(custom.get("dim", custom.get("width", 128))),
        heads=int(custom.get("heads", 8)),
        head_dim=int(custom.get("head_dim", 16)),
        mlp=int(custom.get("mlp", 512)),
        layers=int(custom.get("layers", 2)),
        experts=int(custom.get("experts", 2)),
        max_seq=int(custom.get("max_seq", max(seq, 64))),
        dtype=parse_dtype(name, torch.device(device or "cpu")))
    if min(cfg.vocab, cfg.dim, cfg.heads, cfg.head_dim, cfg.mlp,
           cfg.layers, cfg.experts, cfg.max_seq) < 1:
        raise ValueError(
            "streamformer_lm: vocab/dim/heads/head_dim/mlp/layers/"
            "experts/max_seq must all be >= 1")
    if "seq" in custom and cfg.max_seq < seq:
        raise ValueError(
            f"streamformer_lm: max_seq={cfg.max_seq} < seq={seq}: the "
            "KV cache could not hold one full input window")
    return cfg


def init_cache(cfg: StreamFormerConfig, device: DeviceLike = None
               ) -> Dict[str, torch.Tensor]:
    """Static-shape KV cache: (layers, max_seq, heads, head_dim), on
    ``device`` (``None``: the card)."""
    shape = (cfg.layers, cfg.max_seq, cfg.heads, cfg.head_dim)
    device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": torch.zeros((), dtype=torch.long, device=device)}


def decode_step(params: Dict[str, Any], cache: Dict[str, torch.Tensor],
                token: torch.Tensor, cfg: StreamFormerConfig
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One incremental step: token () int → (logits (vocab,), cache').
    The cache's K/V are written in place; ``pos`` advances in the
    returned dict.  Positions past ``pos`` are masked."""
    pos = cache["pos"]
    logits, _, _ = decode_step_pooled(
        params, cache["k"][None], cache["v"][None],
        torch.as_tensor(token, device=pos.device).reshape(1),
        pos.reshape(1), torch.zeros(1, dtype=torch.long, device=pos.device),
        cfg)
    return logits[0], {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def generate(params: Dict[str, Any], cfg: StreamFormerConfig,
             prompt: np.ndarray, n_tokens: int, temperature: float = 0.0,
             seed: int = 0) -> np.ndarray:
    """Greedy (temperature 0) or sampled continuation: the prompt and then
    each generated token go through :func:`decode_step`, eagerly, on the
    parameters' device.  Greedy output equals the JAX package's for the
    same parameters; sampling draws from a ``torch.Generator`` seeded
    with ``seed``, which JAX's PRNG cannot reproduce."""
    prompt = np.asarray(prompt, np.int64)
    total = prompt.shape[0] + n_tokens
    if total > cfg.max_seq:
        raise ValueError(
            f"prompt ({prompt.shape[0]}) + n_tokens ({n_tokens}) = "
            f"{total} exceeds max_seq={cfg.max_seq}: the KV cache would "
            "clamp positions and silently corrupt the continuation")
    device = params["embed"].device
    gen = torch.Generator(device=device).manual_seed(int(seed))
    cache = init_cache(cfg, device)
    toks = torch.as_tensor(prompt, device=device)
    out = []
    with torch.inference_mode():
        logits = None
        for tok in toks:
            logits, cache = decode_step(params, cache, tok, cfg)
        for _ in range(n_tokens):
            if temperature > 0:
                probs = torch.softmax(logits / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=gen)[0]
            else:
                tok = torch.argmax(logits)
            out.append(tok)
            logits, cache = decode_step(params, cache, tok, cfg)
    if not out:
        return np.zeros((0,), np.int32)
    return torch.stack(out).cpu().numpy().astype(np.int32)


class StreamFormerLM(nn.Module):
    """The registry model: tokens ``([B,] T)`` int32 → ``(logits ([B,] T,
    vocab) f32,)``.  ``params`` is the plain tree, already on its
    device."""

    def __init__(self, params: Dict[str, Any],
                 cfg: StreamFormerConfig) -> None:
        super().__init__()
        self.params = params
        self.cfg = cfg

    def forward(self, tokens: torch.Tensor) -> Tuple[torch.Tensor]:
        return (forward_logits(self.params, tokens, self.cfg).float(),)

    def checkpoint_tensors(self) -> Dict[str, torch.Tensor]:
        """The tree's leaves by dotted path (``layers.<i>.<name>``), the
        names a ``framework=mesh`` trainer's checkpoint carries."""
        from .registry import named_tensors

        return named_tensors(self.params)


def _build_registry_model(custom_props: Dict[str, str],
                          device: DeviceLike = None):
    """``framework=xla model=streamformer_lm``: full-sequence next-token
    logits as a pipeline filter — tokens in (T,) int32, logits out
    (T, vocab) float32."""
    from ..tensor.info import TensorInfo, TensorsInfo
    from ..tensor.types import TensorType
    from .registry import Model

    device = resolve_device(device)
    seed = int(custom_props.get("seed", 0))
    seq = int(custom_props.get("seq", 64))
    cfg = config_from_custom(custom_props, device=device)
    params = place_params(init_params(cfg, seed), cfg, device)
    in_info = TensorsInfo([TensorInfo(TensorType.INT32, (seq,))])
    out_info = TensorsInfo([TensorInfo(TensorType.FLOAT32,
                                       (cfg.vocab, seq))])
    module = StreamFormerLM(params, cfg)
    return Model(name="streamformer_lm", module=module, device=device,
                 in_info=in_info, out_info=out_info, batched=module)


def _register():
    from .registry import register_model

    register_model("streamformer_lm")(_build_registry_model)


_register()
