"""LM assembly: embeddings + block groups + loss/prefill/decode.

Torch translation of the JAX package's ``models/model.py`` for the families
whose blocks are ported (dense, hybrid, ssm, vlm, encdec).  A vlm config's
model projects precomputed image patch embeddings (``batch["image_embeds"]``,
(B, n_img_tokens, vision_embed_dim)) with ``patch_proj`` and puts them in
front of the token embeddings; the loss masks those positions.  An encdec
config's model (whisper) runs its encoder over precomputed frame embeddings
(``batch["frames"]``, (B, enc_seq, d_model); the conv frontend is a stub,
as in the reference) in ``apply``, ``loss`` and ``prefill``, without a
checkpoint, and hands its output to every decoder block.  The reference's
decoder blocks are ``attn_mlp`` (``configs/base.py:scan_groups``), which do
not read it: its parameters get zero gradients.  The params
keep the JAX tree, ``groups/g{gi}/b{bi}/...`` with a leading repeats axis
per group, so a JAX params tree carries over leaf for leaf
(:func:`from_jax_lm_params`).  ``lax.scan`` over a group becomes a plain
loop over its repeats.  Under autograd in train mode (``loss``), each
repeat runs under ``torch.utils.checkpoint`` as ``cfg.remat`` says, as JAX
checkpoints each scan step: "full" saves nothing inside a repeat, "dots"
saves the outputs of the matrix products without batch dimensions, "none"
does not remat.

The decode cache is written in place: each block's new cache is copied into
the stacked buffers of ``init_cache``, and ``pos`` is a Python int, so a
decode step reads no device value on the host.
"""
from __future__ import annotations

from collections.abc import Mapping
from functools import partial

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.blocks import BLOCKS
from repro_torch.tree import tree_leaves, tree_map  # noqa: F401 (re-exported)

PORTED_FAMILIES = ("dense", "hybrid", "ssm", "vlm", "encdec")


def nest_params(flat: Mapping) -> dict:
    """A dotted leaf dict (``ParamPacker.unpack``'s ``"groups.g0.b0.ln1.
    scale"``) as the LM's nested tree, holding the same tensors."""
    tree: dict = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def _dots_policy(ctx, op, *args, **kwargs):
    """``cfg.remat == "dots"``: keep the outputs of the 2-D matrix products
    (JAX's ``dots_with_no_batch_dims_saveable``), recompute the rest."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: str):
    """``fn`` run under the checkpoint ``remat`` names (JAX's
    ``_remat_policy``), or ``fn`` itself for "none"."""
    if remat == "none":
        return fn
    if remat == "full":
        return partial(checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return partial(checkpoint, fn, use_reentrant=False,
                       context_fn=partial(create_selective_checkpoint_contexts,
                                          _dots_policy))
    raise ValueError(f"remat must be 'full', 'dots' or 'none', got {remat!r}")


def _copy_into(dst, src):
    """Copy the leaves of ``src`` into the matching leaves of ``dst`` in
    place, skipping a leaf that already is the destination's storage."""
    for k, v in src.items():
        if isinstance(v, Mapping):
            _copy_into(dst[k], v)
        elif v.data_ptr() != dst[k].data_ptr():
            dst[k].copy_(v)


class LM:
    def __init__(self, cfg, device=None):
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family!r} family is not ported yet "
                f"(its blocks are in ROADMAP.md, Queue A)")
        self.cfg = cfg
        self.device = (torch.device("meta") if str(device) == "meta"
                       else resolve_device(device))
        self.pdtype = L.DTYPES[cfg.param_dtype]
        self.adtype = L.DTYPES[cfg.dtype]

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator | None = None) -> dict:
        """Random params from ``gen`` (a generator on this model's device),
        with the JAX init's shapes, dtypes and scales."""
        cfg, dev, pd = self.cfg, self.device, self.pdtype
        params: dict = {
            "embed": {"w": L._normal(gen, (cfg.padded_vocab, cfg.d_model),
                                     cfg.d_model ** -0.5, pd, dev)},
        }
        if not cfg.tie_embeddings:
            params["unembed"] = L.linear_init(gen, cfg.d_model,
                                              cfg.padded_vocab, pd, dev)
        params["final_norm"] = L.norm_init(cfg.d_model, dev,
                                           bias=cfg.family == "encdec")
        params["groups"] = {
            f"g{gi}": {f"b{bi}": BLOCKS[b][0](gen, cfg, pd, dev, lead=(reps,))
                       for bi, b in enumerate(pattern)}
            for gi, (pattern, reps) in enumerate(cfg.scan_groups())}
        if cfg.family == "encdec":
            params["encoder"] = {
                "blocks": {"b0": BLOCKS["enc"][0](
                    gen, cfg, pd, dev, lead=(cfg.n_enc_layers,))},
                "final_norm": L.norm_init(cfg.d_model, dev, bias=True)}
        if cfg.family == "vlm":
            params["patch_proj"] = L.linear_init(gen, cfg.vision_embed_dim,
                                                 cfg.d_model, pd, dev)
        return params

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int, dtype=None) -> dict:
        cfg = self.cfg
        dtype = dtype or self.adtype
        groups = {
            f"g{gi}": {f"b{bi}": BLOCKS[b][1](cfg, batch, max_len, dtype,
                                              self.device, lead=(reps,))
                       for bi, b in enumerate(pattern)}
            for gi, (pattern, reps) in enumerate(cfg.scan_groups())}
        return {"groups": groups, "pos": 0}

    # ------------------------------------------------------------ block loop
    def _run_groups(self, params, x, *, mode, cache, pos, enc_out=None):
        cfg = self.cfg
        if cache is None:
            def repeat(x, rp, enc_out, pattern):
                for bi, bname in enumerate(pattern):
                    x, _ = BLOCKS[bname][2](rp[f"b{bi}"], x, cfg, mode=mode,
                                            cache=None, pos=pos,
                                            enc_out=enc_out)
                return x.to(self.adtype)
            if mode == "train" and torch.is_grad_enabled():
                # enc_out is an argument: its gradient flows from each rerun
                repeat = _remat(repeat, cfg.remat)
            for gi, (pattern, reps) in enumerate(cfg.scan_groups()):
                # unbind once: its backward stacks the repeats' gradients
                rows = tree_map(lambda t: t.unbind(0),
                                params["groups"][f"g{gi}"])
                for r in range(reps):
                    x = repeat(x, tree_map(lambda t: t[r], rows), enc_out,
                               pattern)
            return x
        for gi, (pattern, reps) in enumerate(cfg.scan_groups()):
            gp = params["groups"][f"g{gi}"]
            gc = cache["groups"][f"g{gi}"]
            for r in range(reps):
                for bi, bname in enumerate(pattern):
                    bp = tree_map(lambda t: t[r], gp[f"b{bi}"])
                    bc = tree_map(lambda t: t[r], gc[f"b{bi}"])
                    x, c_new = BLOCKS[bname][2](bp, x, cfg, mode=mode,
                                                cache=bc, pos=pos,
                                                enc_out=enc_out)
                    _copy_into(bc, c_new)
                x = x.to(self.adtype)
        return x

    # ----------------------------------------------------------------- embed
    def _embed(self, params, tokens):
        w = params["embed"]["w"]
        return w[tokens].to(self.adtype) * self.cfg.scale_emb

    def _unembed(self, params, x):
        cfg = self.cfg
        norm = L.layernorm if cfg.family == "encdec" else L.rmsnorm
        x = norm(params["final_norm"], x, cfg.norm_eps)
        if cfg.tie_embeddings:
            logits = x @ params["embed"]["w"].to(x.dtype).T
        else:
            logits = L.linear(params["unembed"], x)
        logits = logits * cfg.logit_scale
        if cfg.padded_vocab != cfg.vocab_size:   # mask padding entries
            valid = torch.arange(cfg.padded_vocab,
                                 device=x.device) < cfg.vocab_size
            logits = logits.masked_fill(~valid, L.NEG_INF)
        return logits

    def _encode(self, params, frames):
        """The encoder over the frame embeddings, in mode "train", no
        cache and no checkpoint (the reference's encoder scan has none),
        then its LayerNorm."""
        cfg = self.cfg
        x = frames.to(self.adtype)
        rows = tree_map(lambda t: t.unbind(0), params["encoder"]["blocks"])
        for r in range(cfg.n_enc_layers):
            x, _ = BLOCKS["enc"][2](tree_map(lambda t: t[r], rows)["b0"], x,
                                    cfg, mode="train")
            x = x.to(self.adtype)
        return L.layernorm(params["encoder"]["final_norm"], x, cfg.norm_eps)

    def _prepend_vision(self, params, x, image_embeds):
        """The projected image embeddings (cast to the activation dtype
        before the product) in front of the token embeddings ``x``."""
        img = L.linear(params["patch_proj"], image_embeds.to(self.adtype))
        return torch.cat([img, x], dim=1)

    def _stream(self, params, batch):
        """(the decoder's input stream, the encoder's output or None): the
        token embeddings, after the image positions of a vlm config; an
        encdec config's encoder run over ``batch["frames"]``."""
        x = self._embed(params, batch["tokens"])
        enc_out = None
        if self.cfg.family == "encdec":
            enc_out = self._encode(params, batch["frames"])
        if self.cfg.family == "vlm":
            x = self._prepend_vision(params, x, batch["image_embeds"])
        return x, enc_out

    # ----------------------------------------------------------- public API
    @torch.no_grad()
    def apply(self, params, batch):
        """batch: {tokens (B, S)[, image_embeds | frames]} -> logits (B,
        S', V), causal, no cache; S' counts the image positions."""
        x, enc_out = self._stream(params, batch)
        x = self._run_groups(params, x, mode="train", cache=None, pos=None,
                             enc_out=enc_out)
        return self._unembed(params, x)

    def loss(self, params, batch, loss_chunk: int = 1024):
        """batch: {tokens, labels (B, S), int, label < 0 masked[,
        image_embeds | frames]} -> (ce + aux, {"ce", "aux"}), f32 scalars; aux is 0
        for the ported families.  A vlm config's image positions get label
        -1.  Sequence-chunked as the JAX ``LM.loss``: with S % C == 0 (C =
        min(loss_chunk, S), S counting the image positions) the unembed +
        CE of each chunk of C positions runs under checkpoint (when
        autograd is on), so the (B, S, V) logits are never live in full;
        otherwise the full CE."""
        x, enc_out = self._stream(params, batch)
        x = self._run_groups(params, x, mode="train", cache=None, pos=None,
                             enc_out=enc_out)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        labels = batch["labels"]
        if self.cfg.family == "vlm":          # no loss on image positions
            labels = torch.cat([torch.full(
                (labels.shape[0], self.cfg.n_img_tokens), -1,
                dtype=labels.dtype, device=labels.device), labels], dim=1)
        mask = (labels >= 0).to(torch.float32)
        labels = torch.clamp(labels, min=0)
        S = x.shape[1]
        C = min(loss_chunk, S)
        if S % C:
            ce = L.cross_entropy(self._unembed(params, x), labels, mask)
            return ce + aux, {"ce": ce, "aux": aux}

        def chunk_nll(xc, lc, mc):
            lf = self._unembed(params, xc).to(torch.float32)
            gold = torch.gather(lf, -1, lc.long()[..., None])[..., 0]
            return torch.sum((torch.logsumexp(lf, dim=-1) - gold) * mc)

        if torch.is_grad_enabled():
            chunk_nll = _remat(chunk_nll, "full")
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, S, C):
            tot = tot + chunk_nll(x[:, i:i + C], labels[:, i:i + C],
                                  mask[:, i:i + C])
        ce = tot / torch.clamp(torch.sum(mask), min=1.0)
        return ce + aux, {"ce": ce, "aux": aux}

    @torch.no_grad()
    def prefill(self, params, batch, cache):
        """Run the prompt (after the image positions of a vlm config; with
        an encdec config's frames), fill ``cache`` in place.  Returns
        (logits of the last position (B, 1, V), cache with ``pos`` = the
        positions run)."""
        x, enc_out = self._stream(params, batch)
        seq = x.shape[1]
        x = self._run_groups(params, x, mode="prefill", cache=cache, pos=None,
                             enc_out=enc_out)
        logits = self._unembed(params, x[:, -1:])
        return logits, {"groups": cache["groups"], "pos": seq}

    @torch.no_grad()
    def decode_step(self, params, tokens, cache):
        """tokens: (B, 1). Returns (logits (B, 1, V), cache one step on)."""
        pos = cache["pos"]
        x = self._embed(params, tokens)
        x = self._run_groups(params, x, mode="decode", cache=cache, pos=pos)
        logits = self._unembed(params, x)
        return logits, {"groups": cache["groups"], "pos": pos + 1}


def build_model(cfg, device=None) -> LM:
    """The port's LM for ``cfg`` on ``device`` (``cuda`` by default; raises
    without a card).  Raises NotImplementedError for the moe family, whose
    blocks are not ported yet."""
    return LM(cfg, device)


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":       # ml_dtypes.bfloat16: lossless via f32
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def from_jax_lm_params(np_tree: Mapping, cfg, device=None) -> dict:
    """A JAX LM params tree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) -> the port's tree, value for
    value: same keys, shapes (the stacked group axis is kept) and dtypes.
    bf16 leaves go through f32, which holds every bf16 value exactly."""
    groups = {f"g{gi}" for gi in range(len(cfg.scan_groups()))}
    if set(np_tree.get("groups", {})) != groups:
        raise ValueError(f"params tree has groups "
                         f"{sorted(np_tree.get('groups', {}))}, {cfg.name} "
                         f"has {sorted(groups)}")
    dev = resolve_device(device)
    return tree_map(lambda x: _to_tensor(x, dev), np_tree)
