"""Prefill/decode program split for generative serving.

Counterpart of the reference package's ``serve/decode.py``, serving the
zoo decoder LM (``models/transformer.py``) from the parameter dict the
reference's ``Module.get_params()`` returns, under the same names
(``tok_embed_weight``, ``layer%d_att_qkv_weight``, ...):

* **prefill** — one runner per prompt bucket ``T_b``: the full causal
  forward over one padded prompt, attention through the port's flash
  forward kernel (:mod:`..ops.flash_attention`) at every bucket, the
  prompt's whole ``T_b`` K/V block (padding included) written into the
  cache slot in place, and only the last real token's row taken through
  the final LayerNorm and the LM head.
* **decode** — one runner per sequence bucket ``S_b`` over the whole
  slot array: embed the freshest token of every slot, write its K/V at
  the slot's own position in place, attend against the cache's
  ``[0:S_b]`` slice with per-slot length masking, and return
  ``(slots, V)`` logits.

The runner set is |prompt buckets| + |decode buckets|, counted by the
server's :class:`~.._fused.CompileCache`. All arithmetic is float32;
on the GPU the engine turns TF32 off for matrix products and cuDNN, as
the reference's serve path computes in full float32.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..context import DeviceLike, resolve_device
from ..ops.flash_attention import flash_attention

__all__ = ["DecodeConfig", "DecodeEngine", "params_from_numpy",
           "config_from_params", "sample_token"]

_LN_EPS = 1e-5          # the reference's layer_norm default


class DecodeConfig:
    """Static geometry of the served transformer."""

    __slots__ = ("num_layers", "d_model", "n_heads", "d_head", "d_ff",
                 "vocab_size", "max_seq")

    def __init__(self, num_layers: int, d_model: int, n_heads: int,
                 d_ff: int, vocab_size: int, max_seq: int):
        if d_model % n_heads:
            raise ValueError("d_model %d not divisible by n_heads %d"
                             % (d_model, n_heads))
        self.num_layers = int(num_layers)
        self.d_model = int(d_model)
        self.n_heads = int(n_heads)
        self.d_head = int(d_model) // int(n_heads)
        self.d_ff = int(d_ff)
        self.vocab_size = int(vocab_size)
        self.max_seq = int(max_seq)


def params_from_numpy(params: Dict[str, np.ndarray],
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Carry the reference package's parameters across: ``name ->
    float32 tensor`` on ``device`` (default ``cuda:0``), under the zoo
    transformer's names. Takes numpy arrays, or anything
    ``np.asarray`` reads (the reference's ``asnumpy()`` output)."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(arr, dtype=np.float32)).to(dev)
            for name, arr in params.items()}


def config_from_params(params: Dict[str, torch.Tensor],
                       n_heads: int) -> DecodeConfig:
    """Infer the transformer geometry from the parameter shapes (head
    count is not shape-derivable — the caller states it)."""
    need = ("tok_embed_weight", "pos_embed_weight", "lm_head_weight",
            "layer0_ff1_weight")
    for k in need:
        if k not in params:
            raise MXNetError(
                "serve decode: parameter %r missing — GenerativeServer "
                "serves the zoo transformer naming convention "
                "(models/transformer.py); found %d params"
                % (k, len(params)))
    vocab, d_model = params["tok_embed_weight"].shape
    max_seq = params["pos_embed_weight"].shape[0]
    d_ff = params["layer0_ff1_weight"].shape[0]
    n_layers = 0
    while ("layer%d_att_qkv_weight" % n_layers) in params:
        n_layers += 1
    return DecodeConfig(n_layers, int(d_model), int(n_heads), int(d_ff),
                        int(vocab), int(max_seq))


def sample_token(logits: np.ndarray, temperature: float = 0.0,
                 rng: Optional[np.random.Generator] = None) -> int:
    """Host-side sampling: greedy at ``temperature=0`` (deterministic),
    else softmax sampling from the caller's per-request generator."""
    if temperature <= 0.0:
        return int(np.argmax(logits))
    z = logits.astype(np.float64) / float(temperature)
    z -= z.max()
    p = np.exp(z)
    p /= p.sum()
    gen = rng or np.random.default_rng()
    return int(gen.choice(len(p), p=p))


# --------------------------------------------------------------- forward


def _ln(x: torch.Tensor, gamma: torch.Tensor,
        beta: torch.Tensor) -> torch.Tensor:
    """LayerNorm with the reference's one-pass statistics,
    var = max(E[x^2] - E[x]^2, 0) — ``F.layer_norm`` differs in the last
    bits."""
    mean = x.mean(dim=-1, keepdim=True)
    msq = (x * x).mean(dim=-1, keepdim=True)
    var = torch.clamp(msq - mean * mean, min=0.0)
    return (x - mean) * torch.rsqrt(var + _LN_EPS) * gamma + beta


def _fc(x: torch.Tensor, params: Dict[str, torch.Tensor],
        name: str) -> torch.Tensor:
    return F.linear(x, params[name + "_weight"], params[name + "_bias"])


def _ffn(x: torch.Tensor, params: Dict[str, torch.Tensor],
         pfx: str) -> torch.Tensor:
    h = _ln(x, params[pfx + "_ln2_gamma"], params[pfx + "_ln2_beta"])
    return x + _fc(torch.relu(_fc(h, params, pfx + "_ff1")), params,
                   pfx + "_ff2")


class DecodeEngine:
    """The runner table: builds and dispatches the per-bucket prefill
    and decode runners over one :class:`~.kv_cache.KVCache`.

    Not thread-safe by design: every method runs on the owning
    GenerativeServer's scheduler thread (the cache is written in place).
    """

    def __init__(self, params: Dict[str, torch.Tensor], n_heads: int,
                 cache, compile_cache, name: str = "serve",
                 prompt_buckets: Optional[Sequence[int]] = None,
                 seq_buckets: Optional[Sequence[int]] = None):
        self.params = params
        self.cfg = config_from_params(params, n_heads)
        self.cache = cache
        self.device = cache.device
        self.compile_cache = compile_cache
        self.name = name
        for pname, t in params.items():
            if t.device != self.device or t.dtype != torch.float32:
                raise MXNetError(
                    "serve decode: parameter %r is %s on %s; the engine "
                    "serves float32 on the cache's device %s"
                    % (pname, t.dtype, t.device, self.device))
        if self.device.type == "cuda":
            # the reference serve path computes in full float32: no TF32
            # in cuBLAS products or cuDNN (process-wide switches)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        from .bucketing import decode_buckets as _ladder
        self.seq_buckets: List[int] = list(
            seq_buckets if seq_buckets is not None
            else _ladder(cache.max_seq, cache.page))
        self.prompt_buckets: List[int] = list(
            prompt_buckets if prompt_buckets is not None
            else self.seq_buckets)
        for b in self.prompt_buckets:
            if b % cache.page:
                raise ValueError("prompt bucket %d not a multiple of the "
                                 "kv page %d" % (b, cache.page))

    def executable_bound(self) -> int:
        return len(self.prompt_buckets) + len(self.seq_buckets)

    def prompt_bucket(self, n: int) -> int:
        for b in self.prompt_buckets:
            if n <= b:
                return b
        raise MXNetError("prompt of %d tokens exceeds max bucket %d"
                         % (n, self.prompt_buckets[-1]))

    def seq_bucket(self, needed: int) -> int:
        for b in self.seq_buckets:
            if needed <= b:
                return b
        raise MXNetError("sequence needs %d cache positions, max bucket %d"
                         % (needed, self.seq_buckets[-1]))

    # ----------------------------------------------------------- runners
    def _run_prefill(self, t_b: int, tokens: torch.Tensor, slot: int,
                     true_len: int) -> torch.Tensor:
        cfg, p = self.cfg, self.params
        x = p["tok_embed_weight"][tokens] + p["pos_embed_weight"][:t_b]
        for li in range(cfg.num_layers):
            pfx = "layer%d" % li
            h = _ln(x, p[pfx + "_ln1_gamma"], p[pfx + "_ln1_beta"])
            qkv = _fc(h, p, pfx + "_att_qkv").view(
                t_b, 3, cfg.n_heads, cfg.d_head)
            q, k, v = (qkv[:, i].transpose(0, 1) for i in range(3))
            # in place: the whole T_b block, padding included (decode
            # masks positions past each sequence's length)
            self.cache.k[li, slot, :, :t_b] = k
            self.cache.v[li, slot, :, :t_b] = v
            ctx = flash_attention(q[None], k[None], v[None],
                                  causal=True)[0]       # (H, T_b, d)
            ctx = ctx.transpose(0, 1).reshape(t_b, cfg.d_model)
            x = _ffn(x + _fc(ctx, p, pfx + "_att_proj"), p, pfx)
        # only the last REAL token goes through the LM head
        row = x[max(true_len - 1, 0)][None]
        row = _ln(row, p["final_ln_gamma"], p["final_ln_beta"])
        return _fc(row, p, "lm_head")[0]

    def _run_decode(self, s_b: int, tokens: torch.Tensor, pos: torch.Tensor,
                    active: torch.Tensor) -> torch.Tensor:
        cfg, p = self.cfg, self.params
        scale = 1.0 / float(np.sqrt(cfg.d_head))
        pos_c = pos.clamp(0, cfg.max_seq - 1)
        slots = torch.arange(tokens.shape[0], device=self.device)
        # keys at 0..pos inclusive: the token just written attends to
        # itself, as in the training graph
        mask = torch.arange(s_b, device=self.device)[None, :] \
            <= pos_c[:, None]                               # (slots, S_b)
        x = p["tok_embed_weight"][tokens] + p["pos_embed_weight"][pos_c]
        for li in range(cfg.num_layers):
            pfx = "layer%d" % li
            h = _ln(x, p[pfx + "_ln1_gamma"], p[pfx + "_ln1_beta"])
            qkv = _fc(h, p, pfx + "_att_qkv").view(
                -1, 3, cfg.n_heads, cfg.d_head)
            q, k_new, v_new = qkv.unbind(1)                 # (slots, H, d)
            k_l, v_l = self.cache.k[li], self.cache.v[li]
            # in place, every slot at its own position (empty slots
            # write into space the next prefill overwrites)
            k_l[slots, :, pos_c] = k_new
            v_l[slots, :, pos_c] = v_new
            kb, vb = k_l[:, :, :s_b], v_l[:, :, :s_b]       # (slots,H,S_b,d)
            s = torch.matmul(kb, q.unsqueeze(-1)).squeeze(-1) * scale
            s = s.masked_fill(~mask[:, None, :], -1e9)
            att = torch.softmax(s, dim=-1)
            ctx = torch.matmul(att.unsqueeze(-2), vb).squeeze(-2)
            ctx = ctx.reshape(-1, cfg.d_model)
            x = _ffn(x + _fc(ctx, p, pfx + "_att_proj"), p, pfx)
        x = _ln(x, p["final_ln_gamma"], p["final_ln_beta"])
        logits = _fc(x, p, "lm_head")                       # (slots, V)
        # finished/empty slots carry garbage rows; mask them so a
        # scheduler bug downstream surfaces as -inf-ish logits, not a
        # plausible token
        return logits.masked_fill(~active[:, None], -1e30)

    # ---------------------------------------------------------- dispatch
    def _dispatch(self, kind: str, bucket: int, runner_fn, args: Tuple):
        """Bucket dispatch under the CompileCache counter discipline:
        the first arrival binds the runner (``<name>_compile``), every
        later arrival is ``<name>_cache_hit``."""
        sig = ("gen_" + kind, bucket)
        runner = self.compile_cache.get(sig)
        with torch.no_grad():
            if runner is None:
                runner = functools.partial(runner_fn, bucket)
                out = runner(*args)
                self.compile_cache.put(sig, runner)
                return out
            out = runner(*args)
        self.compile_cache.note_success(sig)
        return out

    def _tensor(self, a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, dtype)

    def prefill(self, prompt: np.ndarray, slot: int) -> np.ndarray:
        """Run one prompt through its bucket's prefill, writing its K/V
        into ``slot``; returns the last real token's logits as host
        numpy (the copy to the host is the device fence)."""
        n = int(prompt.shape[0])
        t_b = self.prompt_bucket(n)
        tokens = np.zeros((t_b,), np.int64)
        tokens[:n] = np.asarray(prompt, np.int64)
        logits = self._dispatch(
            "prefill", t_b, self._run_prefill,
            (self._tensor(tokens, torch.int64), int(slot), n))
        return logits.cpu().numpy()

    def decode_step(self, tokens: np.ndarray, pos: np.ndarray,
                    active: np.ndarray) -> np.ndarray:
        """One decode step over the whole slot array; returns
        ``(slots, V)`` logits on host. ``pos[s]`` is the write position
        (current length) of slot ``s``; inactive slots pass 0/False."""
        active = np.asarray(active, bool)
        needed = int(pos[active].max()) + 1 if active.any() else 1
        s_b = self.seq_bucket(needed)
        logits = self._dispatch(
            "decode", s_b, self._run_decode,
            (self._tensor(tokens, torch.int64), self._tensor(pos, torch.int64),
             self._tensor(active, torch.bool)))
        return logits.cpu().numpy()
