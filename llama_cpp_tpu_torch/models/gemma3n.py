"""Gemma 3n and Gemma 4 text graphs, and the Gemma 4 MTP assistant.

Port of the JAX package's models/gemma3n.py (reference src/models/gemma3n.cpp,
gemma4.cpp, gemma4-assistant.cpp), in its arithmetic:
  * Gemma 3n (forward): the n_altup residual streams (one stacked [A, B, T,
    E] tensor), AltUp's predict and correct, LAUREL's low-rank residual,
    the per-layer token embeddings injected into the non-first streams,
    the Gaussian top-k activation sparsity on the FFN gate, the stream
    merge; cross-layer KV sharing through the ISWA memory's aliased lines
    (models/transformer.attention_block);
  * Gemma 4 (forward_gemma4): sandwich norms, the shared-KV tail, the
    dual-branch MoE (a dense FFN plus experts whose router reads a
    weightless norm of the attention output), per-layer embeddings and
    the per-layer output scalar;
  * the assistant (assistant_forward, Gemma4AssistantSpeculator): a q-only
    draft over the target context's live KV at a fixed position, chaining
    its own projected hidden row from one draft step to the next.

The attention and FFN products are the shared decoder's (the qmm and
attention kernels on the card); AltUp's projections are dequantized to f32
and multiplied plainly, as the JAX package does (_dense).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.basic import ACTIVATIONS, rms_norm
from ..ops.qtensor import QuantTensor, embed_lookup, matmul
from .config import ModelConfig
from .transformer import AttnInputs, attention_block, moe_block, norm


def _rms_mag(x: torch.Tensor) -> torch.Tensor:
    """sqrt(mean(x^2)) over the last axis in f32, no epsilon."""
    xf = x.float()
    return torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True))


def _mag_scale(h: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """h rescaled to the target rms magnitude, the new magnitude clamped at
    1e-5 before the sqrt (modeling_gemma3n.py:1655-1663)."""
    hf = h.float()
    new = torch.sqrt(torch.clamp(torch.mean(hf * hf, dim=-1, keepdim=True), min=1e-5))
    return (hf * target / new).to(h.dtype)


def _dense(w) -> torch.Tensor:
    return w.dequant(torch.float32) if isinstance(w, QuantTensor) else w


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap


def _altup_modalities(xs_act, lw, cfg, kernels):
    """tanh(router(norm(x) / n_embd)) -> [B, T, A] f32."""
    r = rms_norm(xs_act, lw["altup_router_norm"], cfg.rms_eps)
    r = r.float() / cfg.n_embd
    return torch.tanh(matmul(r, lw["altup_router"], dtype=torch.float32, kernels=kernels))


def _altup_predict(xs, lw, cfg, act_idx, kernels):
    """xs [A, B, T, E] -> the predictions [A, B, T, E]: coefficient o = i*A + a
    mixes source stream a into prediction i."""
    A = xs.shape[0]
    mods = _altup_modalities(xs[act_idx], lw, cfg, kernels)
    coefs = matmul(mods, lw["altup_predict_coef"], dtype=torch.float32, kernels=kernels)
    coefs = coefs.reshape(*mods.shape[:-1], A, A)  # [B, T, i, a]
    preds = torch.einsum("btia,abte->ibte", coefs, xs.float())
    return (preds + xs.float()).to(xs.dtype)


def _altup_correct(preds, activated, lw, cfg, act_idx, kernels):
    """The innovation of the active stream, broadcast to every stream scaled
    by its coefficient + 1."""
    mods = _altup_modalities(activated, lw, cfg, kernels)
    innovation = activated.float() - preds[act_idx].float()  # [B, T, E]
    coefs = matmul(mods, lw["altup_correct_coef"], dtype=torch.float32, kernels=kernels) + 1.0
    corrected = coefs.permute(2, 0, 1)[..., None] * innovation[None] + preds.float()
    return corrected.to(preds.dtype)


def _gaussian_topk(x: torch.Tensor, std_mult: float) -> torch.Tensor:
    """relu(x - (mean + std_mult * std)), the std biased."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    std = torch.sqrt(((xf - mean) ** 2).mean(dim=-1, keepdim=True))
    return torch.clamp(xf - (mean + std * std_mult), min=0.0).to(x.dtype)


def _laurel(h, lw, cfg, kernels):
    t = matmul(matmul(h, lw["laurel_l"], kernels=kernels), lw["laurel_r"], kernels=kernels)
    return h + rms_norm(t, lw["laurel_post_norm"], cfg.rms_eps)


def _gate_up(lw, h, kernels):
    """The FFN's gate and up products, from the load-time fused [gate | up]
    projection where there is one."""
    if "ffn_gateup" in lw:
        gu = matmul(h, lw["ffn_gateup"], kernels=kernels)
        half = gu.shape[-1] // 2
        return gu[..., :half], gu[..., half:]
    return matmul(h, lw["ffn_gate"], kernels=kernels), matmul(h, lw["ffn_up"], kernels=kernels)


def _geglu(lw, h, act, kernels):
    gate, up = _gate_up(lw, h, kernels)
    return act(gate) * up


def _per_layer_inputs(params, cfg, x0, tokens, Ep, kernels):
    """The per-layer token embeddings, projected and mixed (gemma3n.cpp:
    319-371) -> [B, T, n_layers, Ep]."""
    B, T = x0.shape[:2]
    L = cfg.n_layers
    cdtype = x0.dtype
    per = embed_lookup(params["per_layer_token_embd"], tokens.long(), dtype=cdtype)
    per = (per.float() * float(Ep) ** 0.5).to(cdtype).reshape(B, T, L, Ep)
    plp = matmul(x0, params["per_layer_model_proj"], dtype=torch.float32, kernels=kernels)
    plp = (plp * float(cfg.n_embd) ** -0.5).reshape(B, T, L, Ep)
    plp = rms_norm(plp, params["per_layer_proj_norm"], cfg.rms_eps)
    return ((plp + per.float()) * (2.0 ** -0.5)).to(cdtype)


def _per_layer_inject(lw, cfg, cur, per_il, act, kernels):
    """The per-layer embedding's residual block: gate -> gelu -> times the
    layer's input -> proj -> post-norm."""
    fp = act(matmul(cur, lw["per_layer_inp_gate"], kernels=kernels)) * per_il
    fp = matmul(fp, lw["per_layer_proj"], kernels=kernels)
    return rms_norm(fp, lw["per_layer_post_norm"], cfg.rms_eps)


def _head(params, cfg, x, output_rows, return_hidden, kernels):
    """[B, T, E] -> the output rows' logits [M, vocab] f32 (softcapped), or
    with return_hidden the normed rows."""
    B, T, E = x.shape
    x = x.reshape(B * T, E)
    if output_rows is not None:
        x = x[output_rows]
    x = norm(cfg, x, params, "output_norm")
    if return_hidden:
        return x
    out_w = params.get("output")
    logits = matmul(x, params["token_embd"] if out_w is None else out_w, dtype=torch.float32,
                    kernels=kernels)
    if cfg.final_logit_softcap:
        logits = _softcap(logits, cfg.final_logit_softcap)
    return logits


def _scaled_embedding(params, cfg, tokens):
    x = embed_lookup(params["token_embd"], tokens.long(), dtype=cfg.compute_dtype)
    return (x.float() * float(cfg.n_embd) ** 0.5).to(x.dtype)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, inputs: AttnInputs, kv,
            output_rows: torch.Tensor | None = None, kernels: bool = True,
            return_hidden: bool = False, tap=None) -> torch.Tensor:
    """Gemma 3n: tokens [B, T] -> logits [M or B*T, vocab] f32 (the JAX
    package's gemma3n.forward); writes the ISWA memory in place. tap, where
    given, gets the merged pre-output-norm row as layer n_layers's input."""
    ex = cfg.extra
    A = int(ex.get("n_altup", 4))
    act_idx = int(ex.get("i_altup_act", 0))
    Ep = int(ex["n_embd_altup"])
    sparsity = ex.get("act_sparsity_std")
    cdtype = cfg.compute_dtype
    gelu = ACTIVATIONS[cfg.act]
    x0 = _scaled_embedding(params, cfg, tokens)
    per = _per_layer_inputs(params, cfg, x0, tokens, Ep, kernels)

    # the one residual stream expanded to n_altup magnitude-matched streams
    target = _rms_mag(x0)
    altup_proj = _dense(params["altup_proj"])  # [A-1, E, E], [out, in] slices
    streams = [x0] + [_mag_scale(matmul(x0, altup_proj[i], kernels=kernels), target)
                      for i in range(A - 1)]
    xs = torch.stack(streams)  # [A, B, T, E]

    for il, lw in enumerate(params["layers"]):
        preds = _altup_predict(xs, lw, cfg, act_idx, kernels)
        active = preds[act_idx]
        h = norm(cfg, active, lw, "attn_norm")
        laurel_out = _laurel(h, lw, cfg, kernels)
        attn = attention_block(cfg, lw, h, inputs, kv, il, kernels=kernels)
        attn = rms_norm(attn, lw["attn_post_norm"], cfg.rms_eps)
        attn_laurel = (((active + attn) + laurel_out).float() * (2.0 ** -0.5)).to(cdtype)

        hf = norm(cfg, attn_laurel, lw, "ffn_norm")
        gate, up = _gate_up(lw, hf, kernels)
        if sparsity is not None and float(sparsity[il]) > 0.0:
            gate = _gaussian_topk(gate, float(sparsity[il]))
        ff = matmul(gelu(gate) * up, lw["ffn_down"], kernels=kernels)
        ff = rms_norm(ff, lw["ffn_post_norm"], cfg.rms_eps)
        corrected = _altup_correct(preds, attn_laurel + ff, lw, cfg, act_idx, kernels)

        # the per-layer input injected into the non-first streams
        # (gemma3n.cpp:230-255)
        fp = _per_layer_inject(
            lw, cfg, corrected[act_idx] * lw["altup_correct_scale"].to(cdtype),
            per[:, :, il], gelu, kernels)
        xs = torch.cat([corrected[:1], corrected[1:] + fp[None]])

    # the streams merged back to one (gemma3n.cpp:263-285)
    target = _rms_mag(xs[act_idx])
    unembd = _dense(params["altup_unembd_proj"])  # [A-1, E, E]
    out = xs[0].float()
    for i in range(A - 1):
        out = out + _mag_scale(matmul(xs[i + 1], unembd[i], kernels=kernels), target).float()
    x = (out / float(A)).to(cdtype)
    if tap is not None:
        tap(cfg.n_layers, x)
    return _head(params, cfg, x, output_rows, return_hidden, kernels)


def forward_gemma4(params, cfg: ModelConfig, tokens: torch.Tensor, inputs: AttnInputs, kv,
                   output_rows: torch.Tensor | None = None, kernels: bool = True,
                   return_hidden: bool = False, tap=None) -> torch.Tensor:
    """Gemma 4 (the JAX package's gemma3n.forward_gemma4): sandwich-norm
    layers with a shared-KV tail, the dual-branch MoE, per-layer embeddings
    and output scalars; tokens [B, T] -> logits f32. tap, where given, gets
    the pre-output-norm row as layer n_layers's input (the assistant's
    feature)."""
    E = cfg.n_embd
    Ep = int(cfg.extra.get("n_embd_altup", 0))
    cdtype = cfg.compute_dtype
    act = ACTIVATIONS[cfg.act]
    x = _scaled_embedding(params, cfg, tokens)
    per = None
    if Ep and "per_layer_token_embd" in params:
        per = _per_layer_inputs(params, cfg, x, tokens, Ep, kernels)

    for il, lw in enumerate(params["layers"]):
        h = norm(cfg, x, lw, "attn_norm")
        attn = attention_block(cfg, lw, h, inputs, kv, il, kernels=kernels)
        attn_out = x + rms_norm(attn, lw["attn_post_norm"], cfg.rms_eps)
        if "ffn_gate_exps" in lw:
            # the dense branch (gemma4.cpp:266-281)
            mlp = matmul(_geglu(lw, norm(cfg, attn_out, lw, "ffn_norm"), act, kernels),
                         lw["ffn_down"], kernels=kernels)
            mlp = rms_norm(mlp, lw["ffn_post_norm_1"], cfg.rms_eps)
            # the experts: the router reads a weightless norm of attn_out,
            # scaled by 1/sqrt(E) and the per-channel router scale
            # (gemma4.cpp:289-293)
            moe_in = rms_norm(attn_out, lw["ffn_pre_norm_2"], cfg.rms_eps)
            rx = rms_norm(attn_out, None, cfg.rms_eps) * (float(E) ** -0.5)
            rx = rx * lw["ffn_gate_inp_s"].to(rx.dtype)
            moe = moe_block(cfg, lw, moe_in, kernels=kernels, router_x=rx)
            moe = rms_norm(moe.to(cdtype), lw["ffn_post_norm_2"], cfg.rms_eps)
            cur = mlp + moe
        else:
            cur = matmul(_geglu(lw, norm(cfg, attn_out, lw, "ffn_norm"), act, kernels),
                         lw["ffn_down"], kernels=kernels)
        x = attn_out + rms_norm(cur, lw["ffn_post_norm"], cfg.rms_eps)
        if per is not None and "per_layer_inp_gate" in lw:
            x = x + _per_layer_inject(lw, cfg, x, per[:, :, il], act, kernels)
        if "layer_out_scale" in lw:
            x = x * lw["layer_out_scale"].reshape(-1)[0].to(x.dtype)
    if tap is not None:
        tap(len(params["layers"]), x)
    return _head(params, cfg, x, output_rows, return_hidden, kernels)


# ---------------------------------------------------------------------------
# the Gemma 4 assistant (an MTP draft over the target's KV)
# ---------------------------------------------------------------------------

def assistant_forward(params, cfg: ModelConfig, tokens: torch.Tensor, h: torch.Tensor,
                      inputs: AttnInputs, tgt_kv, tgt_tok_embd, kernels: bool = True):
    """One draft step (reference gemma4-assistant.cpp): concat(the target's
    token embedding * sqrt(E_target), h) through nextn.pre_projection, then
    every layer's q-only attention over the target's memory (cfg's kv_reuse
    maps each draft layer onto the target's last layer of its class) ->
    (logits [B*T, vocab] f32, h_next [B, T, E_target] f32, the
    post-projection of the normed hidden row that feeds the next step)."""
    E = cfg.n_embd
    Ebb = int(cfg.extra["n_embd_out"])
    cdtype = cfg.compute_dtype
    act = ACTIVATIONS[cfg.act]
    B, T = tokens.shape
    x = embed_lookup(tgt_tok_embd, tokens.long(), dtype=cdtype)
    x = (x.float() * float(Ebb) ** 0.5).to(cdtype)
    cur = matmul(torch.cat([x, h.to(cdtype)], dim=-1), params["nextn_proj_pre"], kernels=kernels)
    for il, lw in enumerate(params["layers"]):
        attn = attention_block(cfg, lw, norm(cfg, cur, lw, "attn_norm"), inputs, tgt_kv, il,
                               kernels=kernels, update_pos=False)
        attn_out = cur + rms_norm(attn, lw["attn_post_norm"], cfg.rms_eps)
        ff = matmul(_geglu(lw, norm(cfg, attn_out, lw, "ffn_norm"), act, kernels),
                    lw["ffn_down"], kernels=kernels)
        cur = attn_out + rms_norm(ff, lw["ffn_post_norm"], cfg.rms_eps)
        if "layer_out_scale" in lw:
            cur = cur * lw["layer_out_scale"].reshape(-1)[0].to(cur.dtype)
    cur = norm(cfg, cur, params, "output_norm")
    out_w = params.get("output")
    logits = matmul(cur.reshape(B * T, E), params["token_embd"] if out_w is None else out_w,
                    dtype=torch.float32, kernels=kernels)
    h_next = matmul(cur, params["nextn_proj_post"], dtype=torch.float32, kernels=kernels)
    return logits, h_next


class Gemma4AssistantSpeculator:
    """The speculator protocol (runtime/speculative.py) for the Gemma 4 MTP
    assistant, the reference's is_mem_shared "draft-mtp" mode
    (common/speculative.cpp:1249-1650; the JAX package's
    gemma3n.py:372-449): no KV of its own; every draft token's query
    attends the target context's live memory at the fixed position n_past,
    writing nothing, and the draft's own h_next chains from one draft step
    to the next. It reads the target's pre-output-norm row of the last
    verified token (Context.decode(aux=True), layer n_layers)."""

    needs_features = True

    def __init__(self, draft_model, ctx, seq: int = 0, p_min: float = 0.75):
        self.cfg = draft_model.cfg
        self.params = draft_model.params
        self.ctx = ctx
        self.seq = seq
        self.p_min = p_min
        tl = ctx.model.cfg.n_layers
        self.target_layers = (tl,)  # the pre-output-norm row; output_norm applies here
        self.cfg.extra["kv_reuse"] = [tl - 2 if self.cfg.is_swa_layer(il) else tl - 1
                                      for il in range(self.cfg.n_layers)]
        self.t_out_norm = ctx.model.params["output_norm"]
        self.tgt_tok_embd = ctx.model.params["token_embd"]
        self.pending_h: np.ndarray | None = None  # [E_target] the normed row

    def reset(self) -> None:
        self.pending_h = None

    def process(self, tokens, feats, pos0: int) -> None:
        """The target's features of a verified batch [n, E]: the last row,
        normed by the target's output_norm, seeds the next draft."""
        n = feats.shape[0] if hasattr(feats, "shape") else len(feats)
        if n == 0:
            return
        f = torch.as_tensor(np.asarray(feats, np.float32))
        h = rms_norm(f, self.t_out_norm.float().cpu(), self.ctx.model.cfg.rms_eps)
        self.pending_h = h[-1].numpy()

    def draft(self, tokens: list[int], n: int) -> list[int]:
        if self.pending_h is None or n <= 0:
            return []
        ctx = self.ctx
        dev = ctx.device
        cur = tokens[-1]
        h = torch.from_numpy(self.pending_h).to(dev)[None, None, :]
        # every draft token at the fixed position n_past (is_mem_shared mode,
        # speculative.cpp:1636-1639)
        inputs = AttnInputs(seq_idx=torch.tensor([self.seq], dtype=torch.int32, device=dev),
                            positions=torch.tensor([[len(tokens) - 1]], dtype=torch.int32,
                                                   device=dev))
        out: list[int] = []
        for _ in range(n):
            logits, h_next = assistant_forward(
                self.params, self.cfg, torch.tensor([[cur]], dtype=torch.int32, device=dev), h,
                inputs, ctx.kv, self.tgt_tok_embd, kernels=ctx.kernels)
            lrow = logits[0].float()
            t = int(torch.argmax(lrow))
            if float(torch.softmax(lrow, dim=-1)[t]) < self.p_min:
                break
            out.append(t)
            cur = t
            h = h_next[:, -1:]
        return out
