"""MiniLM-class text encoder in PyTorch: port of ``pathway_tpu/models/embedder.py``.

A transformer encoder whose forward runs in bf16 on the card: mean-pooled, L2-normalised sentence
embeddings. Two architectures: "preln", the self-contained encoder with a seeded init, and "bert",
post-layernorm with biases, which loads MiniLM-class HF checkpoints as they are. The attention
goes through the hand-written kernel of ``ops/attention.py``; the matmuls, layer norms and GELU
are PyTorch ops, as XLA left them outside any kernel of the JAX package's own.

The numerics follow the JAX package's, step by step: bf16 @ bf16 products are bf16, layer norm
statistics are f32 with the population variance, the preln block uses tanh-GELU (``jax.nn.gelu``'s
default) and the bert block exact erf-GELU.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..ops.attention import masked_attention

__all__ = [
    "EmbedderConfig", "Embedder", "init_params", "embed_tokens", "load_hf_state_dict",
    "params_from_jax", "tokenize_batch", "hash_word",
]


@dataclasses.dataclass(frozen=True)
class EmbedderConfig:
    vocab_size: int = 30528
    dim: int = 384
    n_layers: int = 6
    n_heads: int = 12
    mlp_ratio: int = 4
    max_len: int = 512
    dtype: torch.dtype = torch.bfloat16
    #: "preln" — the self-contained seeded-init encoder;
    #: "bert" — post-layernorm with biases, numerically matching HF BertModel
    arch: str = "preln"
    ln_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def _tree_to(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def init_params(cfg: EmbedderConfig, seed: int = 0, *,
                device: str | torch.device = "cuda") -> dict:
    """A parameter tree of f32 master weights, drawn from a ``torch.Generator`` seeded with
    ``seed`` on the CPU (so the CPU and the card get the same weights). The numbers differ from
    those ``jax.random`` gives the JAX package for the same seed: to compare the two, carry the
    JAX package's params across with :func:`params_from_jax`."""
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def dense(fan_in: int, shape: tuple[int, ...]) -> torch.Tensor:
        return torch.randn(shape, generator=gen, dtype=torch.float32) / math.sqrt(fan_in)

    params: dict = {
        "tok_emb": dense(cfg.dim, (cfg.vocab_size, cfg.dim)),
        "pos_emb": dense(cfg.dim, (cfg.max_len, cfg.dim)),
        "ln_f_scale": torch.ones(cfg.dim),
        "ln_f_bias": torch.zeros(cfg.dim),
        "layers": [],
    }
    hidden = cfg.dim * cfg.mlp_ratio
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "qkv": dense(cfg.dim, (cfg.dim, 3 * cfg.dim)),
            "proj": dense(cfg.dim, (cfg.dim, cfg.dim)),
            "mlp_in": dense(cfg.dim, (cfg.dim, hidden)),
            "mlp_out": dense(hidden, (hidden, cfg.dim)),
            "ln1_scale": torch.ones(cfg.dim),
            "ln1_bias": torch.zeros(cfg.dim),
            "ln2_scale": torch.ones(cfg.dim),
            "ln2_bias": torch.zeros(cfg.dim),
        })
    return _tree_to(params, dev)


def _f32(v: Any) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to(torch.float32)
    return torch.from_numpy(np.array(v, dtype=np.float32))


def params_from_jax(tree: Any, *, device: str | torch.device = "cuda") -> Any:
    """The JAX package's param pytree (dicts and lists of arrays) as the port's params: the same
    tree of f32 tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device=dev) for v in tree]
    return _f32(tree).to(dev)


def _layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def _heads(t: torch.Tensor, cfg: EmbedderConfig) -> torch.Tensor:
    """``[b, s, heads * head_dim]`` -> ``[b, heads, s, head_dim]``: every head of the config, or a
    tensor-parallel rank's share of them."""
    b, s, _ = t.shape
    return t.view(b, s, -1, cfg.head_dim).transpose(1, 2)


def _merge_heads(out: torch.Tensor) -> torch.Tensor:
    b, _, s, _ = out.shape
    return out.transpose(1, 2).reshape(b, s, -1)


def _block(x: torch.Tensor, layer: dict, cfg: EmbedderConfig, mask: torch.Tensor,
           tp: Any = None) -> torch.Tensor:
    """The preln block. With ``tp`` (``models/pipeline.py``'s model axis), ``layer`` holds one
    rank's shard of ``qkv`` and ``mlp_in`` (column-split, whole heads) and of ``proj`` and
    ``mlp_out`` (row-split): ``tp.enter`` goes before each column-split product and
    ``tp.exit`` sums the row-split products over the axis."""
    dt = cfg.dtype
    enter, exit_ = (tp.enter, tp.exit) if tp is not None else (_same, _same)
    h = enter(_layernorm(x, layer["ln1_scale"], layer["ln1_bias"]))
    q, k, v = (h @ layer["qkv"].to(dt)).chunk(3, dim=-1)
    out = masked_attention(_heads(q, cfg), _heads(k, cfg), _heads(v, cfg), mask)
    x = x + exit_(_merge_heads(out) @ layer["proj"].to(dt))
    h = enter(_layernorm(x, layer["ln2_scale"], layer["ln2_bias"]))
    h = F.gelu(h @ layer["mlp_in"].to(dt), approximate="tanh")
    return x + exit_(h @ layer["mlp_out"].to(dt))


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _bert_block(x: torch.Tensor, layer: dict, cfg: EmbedderConfig,
                mask: torch.Tensor) -> torch.Tensor:
    """Post-layernorm encoder block matching HF BertLayer (dense biases, residual then LN,
    exact erf GELU), softmax and layer norm statistics in f32."""
    dt = cfg.dtype

    def dense(t: torch.Tensor, name: str) -> torch.Tensor:
        return t @ layer[f"{name}_w"].to(dt) + layer[f"{name}_b"].to(dt)

    q, k, v = (_heads(dense(x, n), cfg) for n in ("q", "k", "v"))
    out = _merge_heads(masked_attention(q, k, v, mask))
    x = _layernorm(x + dense(out, "proj"), layer["ln1_scale"], layer["ln1_bias"], cfg.ln_eps)
    h = F.gelu(dense(x, "mlp_in").float(), approximate="none")
    return _layernorm(
        x + dense(h.to(dt), "mlp_out"), layer["ln2_scale"], layer["ln2_bias"], cfg.ln_eps
    )


def embed_tokens(params: dict, token_ids: torch.Tensor, cfg: EmbedderConfig, *,
                 tp: Any = None) -> torch.Tensor:
    """token_ids int ``[batch, seq]`` (0 = pad) -> f32 ``[batch, dim]``, L2-normalised
    (mean pooling + normalise — the sentence-transformers MiniLM head). ``tp``: the
    tensor-parallel model axis of ``models/pipeline.py``, for ``params`` cut by its
    ``param_shardings`` (the preln arch; the bert arch's weights stay whole, as the
    reference's layout leaves them)."""
    token_ids = token_ids.long()
    mask = token_ids > 0
    s = token_ids.shape[1]
    dt = cfg.dtype
    # F.embedding, not tok_emb[token_ids]: the same gather, but its backward sums repeated ids
    # (pads, the augmented view's 1s) in parallel, where indexing's adds them one after another
    x = F.embedding(token_ids, params["tok_emb"]).to(dt) + params["pos_emb"][:s].to(dt)[None, :, :]
    if cfg.arch == "bert":
        x = x + params["type_emb"][0].to(dt)[None, None, :]
        x = _layernorm(x, params["emb_ln_scale"], params["emb_ln_bias"], cfg.ln_eps)
        for layer in params["layers"]:
            x = _bert_block(x, layer, cfg, mask)
    else:
        for layer in params["layers"]:
            x = _block(x, layer, cfg, mask, tp)
        x = _layernorm(x, params["ln_f_scale"], params["ln_f_bias"])
    m = mask[:, :, None].float()
    pooled = (x.float() * m).sum(1) / m.sum(1).clamp_min(1.0)
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp_min(1e-9)


def load_hf_state_dict(
    state_dict: dict, *, n_heads: int | None = None, device: str | torch.device = "cuda"
) -> tuple[dict, EmbedderConfig]:
    """Map a HF ``BertModel``/MiniLM state dict onto the encoder's params. HF Linear weights are
    (out, in) and are transposed to the (in, out) matmul layout. Takes torch tensors or arrays,
    and the ``bert.``-prefixed naming some exports use."""
    dev = resolve_device(device)
    sd = {k.removeprefix("bert."): v for k, v in state_dict.items()}
    tok = _f32(sd["embeddings.word_embeddings.weight"])
    pos = _f32(sd["embeddings.position_embeddings.weight"])
    n_layers = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("encoder.layer."))
    inter = _f32(sd["encoder.layer.0.intermediate.dense.weight"]).shape[0]
    dim = tok.shape[1]
    if n_heads is None:
        # the head count is not derivable from tensor shapes, and the head partition changes
        # the attention output: it comes from the checkpoint's config.json or the caller
        raise ValueError(
            "load_hf_state_dict: pass n_heads= (attention output depends on the head "
            "partition; it cannot be inferred from tensor shapes — see num_attention_heads in "
            "the checkpoint's config.json)"
        )
    cfg = EmbedderConfig(
        vocab_size=tok.shape[0], dim=dim, n_layers=n_layers, n_heads=n_heads,
        mlp_ratio=max(1, inter // dim), max_len=pos.shape[0], arch="bert", ln_eps=1e-12,
    )
    params: dict = {
        "tok_emb": tok,
        "pos_emb": pos,
        "type_emb": _f32(sd["embeddings.token_type_embeddings.weight"]),
        "emb_ln_scale": _f32(sd["embeddings.LayerNorm.weight"]),
        "emb_ln_bias": _f32(sd["embeddings.LayerNorm.bias"]),
        "layers": [],
    }
    for i in range(n_layers):
        p = f"encoder.layer.{i}."
        layer = {}
        for ours, theirs in (
            ("q", "attention.self.query"),
            ("k", "attention.self.key"),
            ("v", "attention.self.value"),
            ("proj", "attention.output.dense"),
            ("mlp_in", "intermediate.dense"),
            ("mlp_out", "output.dense"),
        ):
            layer[f"{ours}_w"] = _f32(sd[p + theirs + ".weight"]).T.contiguous()
            layer[f"{ours}_b"] = _f32(sd[p + theirs + ".bias"])
        layer["ln1_scale"] = _f32(sd[p + "attention.output.LayerNorm.weight"])
        layer["ln1_bias"] = _f32(sd[p + "attention.output.LayerNorm.bias"])
        layer["ln2_scale"] = _f32(sd[p + "output.LayerNorm.weight"])
        layer["ln2_bias"] = _f32(sd[p + "output.LayerNorm.bias"])
        params["layers"].append(layer)
    return _tree_to(params, dev), cfg


class Embedder:
    """Host-facing embedder: texts or token ids in, L2-normalised embeddings out."""

    def __init__(self, cfg: EmbedderConfig | None = None, seed: int = 0,
                 params: dict | None = None, tokenizer: Any = None, *,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg or EmbedderConfig()
        self.params = (
            _tree_to(params, self.device) if params is not None
            else init_params(self.cfg, seed, device=self.device)
        )
        self.tokenizer = tokenizer

    @classmethod
    def from_pretrained(
        cls, source: Any, *, tokenizer: Any = None, dtype: torch.dtype | None = None,
        n_heads: int | None = None, device: str | torch.device = "cuda",
    ) -> "Embedder":
        """Build from a pretrained MiniLM/BERT checkpoint.

        ``source``: a HF state dict (pass ``n_heads=``: the head partition is not derivable from
        tensor shapes), or a local directory with ``pytorch_model.bin`` and ``config.json``
        (``num_attention_heads`` is read from it) and optionally ``vocab.txt``, which becomes the
        WordPiece tokenizer. No network access is attempted."""
        dev = resolve_device(device)
        if isinstance(source, (str, os.PathLike)):
            path = os.fspath(source)
            state_dict = torch.load(
                os.path.join(path, "pytorch_model.bin"), map_location="cpu", weights_only=True
            )
            cfg_file = os.path.join(path, "config.json")
            if n_heads is None and os.path.exists(cfg_file):
                with open(cfg_file) as f:
                    n_heads = int(json.load(f)["num_attention_heads"])
            vocab_file = os.path.join(path, "vocab.txt")
            if tokenizer is None and os.path.exists(vocab_file):
                from .wordpiece import WordPieceTokenizer

                tokenizer = WordPieceTokenizer.from_vocab_file(vocab_file)
        else:
            state_dict = source
        params, cfg = load_hf_state_dict(state_dict, n_heads=n_heads, device=dev)
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        return cls(cfg, params=params, tokenizer=tokenizer, device=dev)

    def _forward(self, toks: np.ndarray) -> torch.Tensor:
        ids = torch.from_numpy(np.ascontiguousarray(toks, dtype=np.int64)).to(self.device)
        with torch.no_grad():
            return embed_tokens(self.params, ids, self.cfg)

    def __call__(self, token_ids: np.ndarray) -> np.ndarray:
        return self._forward(np.asarray(token_ids)).cpu().numpy()

    def embed_texts_device(self, texts: list[str], max_len: int = 128) -> torch.Tensor:
        """Embeddings as a tensor on the device (no host fetch), so that a consumer on the device
        (the KNN scorer) chains on without a round trip.

        Each text runs at its own bucket: the smallest power of two covering its real tokens, at
        least 16 and at most the token width. Pad columns are masked out of attention and the
        pool, and each text's embedding is a function of the text and its bucket alone, never of
        the other texts in the batch. Texts group by bucket; each group runs one forward, and the
        results are put back in input order."""
        max_len = min(max_len, self.cfg.max_len)  # position-table bound
        if self.tokenizer is not None:
            toks = self.tokenizer.encode_batch(texts, max_len)
        else:
            if self.cfg.arch == "bert":
                raise RuntimeError(
                    "pretrained (arch='bert') embedder has no tokenizer: the hashing stand-in "
                    "would feed token ids the checkpoint was never trained on — load with a "
                    "vocab.txt (WordPiece) or pass tokenizer="
                )
            toks = tokenize_batch(texts, self.cfg.vocab_size, max_len)
        toks = np.asarray(toks, dtype=np.int32)
        n, width = toks.shape
        if n == 0:
            return torch.zeros((0, self.cfg.dim), dtype=torch.float32, device=self.device)
        lengths = (toks > 0).sum(axis=1)
        buckets = np.maximum(16, 2 ** np.ceil(np.log2(np.maximum(lengths, 1))).astype(np.int64))
        buckets = np.minimum(buckets, width)
        uniq = np.unique(buckets)
        if len(uniq) == 1:
            return self._forward(toks[:, : int(uniq[0])])
        out = torch.zeros((n, self.cfg.dim), dtype=torch.float32, device=self.device)
        for b in uniq.tolist():
            ix = np.flatnonzero(buckets == b)
            out[torch.from_numpy(ix).to(self.device)] = self._forward(toks[ix, :b])
        return out

    def embed_texts(self, texts: list[str], max_len: int = 128) -> np.ndarray:
        return self.embed_texts_device(texts, max_len).cpu().numpy()


def tokenize_batch(texts: list[str], vocab_size: int, max_len: int) -> np.ndarray:
    """Port of ``pathway_tpu/models/embedder.py::tokenize_batch``, giving the same ids: the
    deterministic hashing tokenizer (feature hashing, a self-contained stand-in for a learned
    vocab). Each distinct word is hashed once per call."""
    out = np.zeros((len(texts), max_len), dtype=np.int32)
    ids: dict[str, int] = {}
    for i, t in enumerate(texts):
        row = []
        for w in t.lower().split()[:max_len]:
            tok = ids.get(w)
            if tok is None:
                tok = ids[w] = (hash_word(w) % (vocab_size - 2)) + 2
            row.append(tok)
        out[i, : len(row)] = row
    return out


def hash_word(w: str) -> int:
    """Copy of ``pathway_tpu/models/embedder.py::hash_word``: 32-bit FNV-1a of the UTF-8 bytes."""
    h = 2166136261
    for ch in w.encode("utf-8"):
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return h
