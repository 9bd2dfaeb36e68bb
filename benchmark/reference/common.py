"""Plain PyTorch pieces shared by the reference models.

Everything here is written from the published descriptions (emoASR, the
Transformer-XL attention, SpecAugment, Adam, the CTC and transducer
lattices), in float32 (float64 for the lattices) with TF32 off, and
imports nothing of the program.  The random streams that a training step
consumes are drawn again from their seeds, in the order the step draws
them:

- dropout outside attention: `F.dropout` from PyTorch's global generator,
  on tensors of the same shapes and layouts, in the same order;
- attention dropout: on the card, the keep bit of (row, head, query, key)
  is one word of a Philox4x32-10 block keyed by a 64-bit seed that the
  layer draws from its own CPU generator (`randint(0, 2**62)`), counter
  (8 (q // 16) + q % 8, k // 2, row * heads + head, 1), word
  2 [q % 16 >= 8] + k % 2, kept where the word >= rate * 2^32; on the CPU,
  a uniform draw of the (B, H, T, T) scores from that generator;
- SpecAugment: widths and starts drawn on the device from the step's
  generator as (B, 20) integer draws, in the order frequency widths,
  frequency starts, time widths, time starts.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

NEG = -1e9
MAX_MASKS = 20
M32 = 0xFFFFFFFF


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# random streams
# ---------------------------------------------------------------------------


def _mul_hi_lo(a: torch.Tensor, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a * b for 32-bit a (int64 tensor) and b,
    without overflowing int64."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    x = a_lo * b  # < 2^48
    y = a_hi * b  # < 2^48
    hi = (y + (x >> 16)) >> 16
    lo = ((y << 16) + x) & M32
    return hi & M32, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors of 32-bit words."""
    for _ in range(10):
        hi0, lo0 = _mul_hi_lo(c0, 0xD2511F53)
        hi1, lo1 = _mul_hi_lo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & M32
        k1 = (k1 + 0xBB67AE85) & M32
    return c0, c1, c2, c3


def attention_keep_mask(seed: int, B: int, H: int, T: int, rate: float, device) -> torch.Tensor:
    """(B, H, T, T) bool keep mask of the card's attention dropout."""
    threshold = min(int(rate * 2 ** 32), 2 ** 32 - 1)
    q = torch.arange(T, device=device, dtype=torch.int64)
    k = torch.arange(T, device=device, dtype=torch.int64)
    bh = torch.arange(B * H, device=device, dtype=torch.int64)
    c0 = (8 * (q // 16) + q % 8)[None, :, None].expand(B * H, T, T)
    c1 = (k // 2)[None, None, :].expand(B * H, T, T)
    c2 = bh[:, None, None].expand(B * H, T, T)
    c3 = torch.ones_like(c0)
    words = philox4x32_10(c0, c1, c2, c3, seed & M32, (seed >> 32) & M32)
    sel = (2 * ((q % 16) >= 8).to(torch.int64))[:, None] + (k % 2)[None, :]  # (T, T) word index
    w = torch.where(sel == 0, words[0], torch.where(sel == 1, words[1], torch.where(sel == 2, words[2], words[3])))
    return (w >= threshold).view(B, H, T, T)


class AttentionDropout:
    """The attention layers' keep masks, drawn as the program's layers draw
    them from their shared CPU generator seeded with `seed`."""

    def __init__(self, seed: int, rate: float):
        self.gen = torch.Generator()
        self.gen.manual_seed(int(seed))
        self.rate = rate

    def mask(self, B: int, H: int, T: int, device) -> Optional[torch.Tensor]:
        if self.rate <= 0.0:
            return None
        if torch.device(device).type == "cuda":
            s = int(torch.randint(0, 2 ** 62, (1,), generator=self.gen).item())
            return attention_keep_mask(s, B, H, T, self.rate, device)
        return torch.rand((B, H, T, T), generator=self.gen) >= self.rate


def spec_augment(gen: torch.Generator, xs: torch.Tensor, xlens: torch.Tensor, cfg: dict) -> torch.Tensor:
    """SpecAugment (Park et al. 2019, emoASR `spec_augment.py`), zero fill:
    `num_masks_freq` frequency masks of width U[0, max_mask_freq) and start
    U[0, F - width), `num_masks_time` time masks of width U[0, max_mask_time)
    and start U[0, xlen - width), a time mask skipped where its width is not
    below xlen."""
    B, T, Fd = xs.shape
    dev = xs.device
    xl = xlens.long()

    def draw(high: int) -> torch.Tensor:
        return torch.randint(0, high, (B, MAX_MASKS), generator=gen, device=dev)

    fw = draw(max(int(cfg["max_mask_freq"]), 1))
    fs = draw(2 ** 30) % torch.clamp(Fd - fw, min=1)
    tw = draw(2 ** 30) % max(int(cfg["max_mask_time"]), 1)
    ts = draw(2 ** 30) % torch.clamp(xl[:, None] - tw, min=1)
    nf, nt = int(cfg["num_masks_freq"]), int(cfg["num_masks_time"])
    fpos = torch.arange(Fd, device=dev)
    tpos = torch.arange(T, device=dev)
    fmask = torch.zeros((B, Fd), dtype=torch.bool, device=dev)
    tmask = torch.zeros((B, T), dtype=torch.bool, device=dev)
    for i in range(nf):
        fmask |= (fpos[None] >= fs[:, i:i + 1]) & (fpos[None] < fs[:, i:i + 1] + fw[:, i:i + 1])
    for i in range(nt):
        ok = (tw[:, i] < xl)[:, None]
        tmask |= ok & (tpos[None] >= ts[:, i:i + 1]) & (tpos[None] < ts[:, i:i + 1] + tw[:, i:i + 1])
    mask = fmask[:, None, :] | tmask[:, :, None]
    return torch.where(mask, torch.zeros_like(xs), xs)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


class Subsampler(nn.Module):
    """Two 3x3 stride-2 convolutions with ReLU, no padding, then a linear
    layer over the channel-major flattening: 4x fewer frames,
    xlen' = ((xlen - 1) // 2 - 1) // 2 (emoASR `encoders/conv.py`)."""

    def __init__(self, feat_dim: int, d: int):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(1, d, 3, 2), nn.ReLU(), nn.Conv2d(d, d, 3, 2), nn.ReLU())
        self.output = nn.Linear(d * (((feat_dim - 1) // 2 - 1) // 2), d)

    def forward(self, xs, xlens):
        h = self.conv(xs[:, None])
        B, C, T2, F2 = h.shape
        return self.output(h.transpose(1, 2).reshape(B, T2, C * F2)), ((xlens - 1) // 2 - 1) // 2


def sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(len, d) table: sin on even channels, cos on odd, of positions / 10000^(2i/d)."""
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=positions.device) * -(math.log(10000.0) / d))
    ang = positions.to(torch.float32)[:, None] * div
    pe = torch.zeros((positions.shape[0], d), dtype=torch.float32, device=positions.device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


def attention(q, k, v, lens, scale: float, keep: Optional[torch.Tensor], rate: float,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax((q k^T + bias) scale) over keys below `lens` (others -1e9,
    zeroed after the softmax), dropout by `keep`, times v; (B, T, H, D)."""
    T = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if bias is not None:
        s = s + bias
    s = s * scale
    valid = torch.arange(T, device=q.device)[None, None, None, :] < lens[:, None, None, None]
    p = torch.softmax(torch.where(valid, s, torch.full_like(s, NEG)), dim=-1)
    p = torch.where(valid, p, torch.zeros_like(p))
    if keep is not None:
        p = torch.where(keep, p * (1.0 / (1.0 - rate)), torch.zeros_like(p))
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


class FeedForward(nn.Module):
    def __init__(self, d: int, f: int, act: str):
        super().__init__()
        self.w1, self.w2, self.act = nn.Linear(d, f), nn.Linear(f, d), act

    def forward(self, x, p: float):
        h = self.w1(x)
        h = torch.relu(h) if self.act == "relu" else F.silu(h)
        return self.w2(F.dropout(h, p, self.training))


class SelfAttention(nn.Module):
    """Multi-head projections (`linear_q/k/v/out`); with `rel`, the
    Transformer-XL relative-position terms (`linear_pos`, `pos_bias_u/v`)."""

    def __init__(self, d: int, heads: int, rel: bool):
        super().__init__()
        self.h, self.dk = heads, d // heads
        self.linear_q, self.linear_k, self.linear_v, self.linear_out = (nn.Linear(d, d) for _ in range(4))
        if rel:
            self.linear_pos = nn.Linear(d, d, bias=False)
            self.pos_bias_u = nn.Parameter(torch.zeros(heads, self.dk))
            self.pos_bias_v = nn.Parameter(torch.zeros(heads, self.dk))

    def forward(self, x, lens, drop: AttentionDropout, pos_emb=None):
        B, T, D = x.shape
        q = self.linear_q(x).view(B, T, self.h, self.dk)
        k = self.linear_k(x).view(B, T, self.h, self.dk)
        v = self.linear_v(x).view(B, T, self.h, self.dk)
        bias = None
        if pos_emb is not None:
            p = self.linear_pos(pos_emb).view(-1, self.h, self.dk)  # (2T-1, H, dk): offsets T-1 .. -(T-1)
            bd = torch.einsum("bqhd,khd->bhqk", q + self.pos_bias_v, p)  # (B, H, T, 2T-1)
            # column j of row i: offset i - j, at index (T - 1) - (i - j)
            idx = (T - 1) - (torch.arange(T, device=x.device)[:, None] - torch.arange(T, device=x.device)[None, :])
            bias = torch.gather(bd, 3, idx[None, None].expand(B, self.h, T, T))
            q = q + self.pos_bias_u
        keep = drop.mask(B, self.h, T, x.device) if self.training else None
        out = attention(q, k, v, lens, 1.0 / math.sqrt(self.dk), keep, drop.rate if keep is not None else 0.0, bias)
        return self.linear_out(out.reshape(B, T, D))


class ConvModule(nn.Module):
    """Pointwise conv to 2C, GLU, depthwise conv (same padding), batch norm
    with the batch's statistics over every frame, swish, pointwise conv."""

    def __init__(self, d: int, kernel: int):
        super().__init__()
        self.kernel = kernel
        self.pointwise_conv1 = nn.Conv1d(d, 2 * d, 1)
        self.depthwise_conv = nn.Conv1d(d, d, kernel, groups=d)
        self.batch_norm = nn.BatchNorm1d(d, eps=1e-5)
        self.pointwise_conv2 = nn.Conv1d(d, d, 1)

    def forward(self, x):
        h = F.glu(self.pointwise_conv1(x.transpose(1, 2)), dim=1)
        h = self.depthwise_conv(F.pad(h, ((self.kernel - 1) // 2, self.kernel // 2)))
        bn = self.batch_norm
        h = F.batch_norm(h, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)
        return self.pointwise_conv2(F.silu(h)).transpose(1, 2)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def ctc_nll(logits: torch.Tensor, elens, labels, ylens, blank: int) -> torch.Tensor:
    """(B,) CTC negative log-likelihoods, the lattice in float64."""
    lp = torch.log_softmax(logits.double(), dim=-1).transpose(0, 1)
    return F.ctc_loss(lp, labels.long(), elens.long(), ylens.long(), blank=blank, reduction="none")


def rnnt_ll(lp_blank: torch.Tensor, lp_label: torch.Tensor, elens, ylens) -> torch.Tensor:
    """(B,) transducer log-likelihoods (Graves 2012): alpha(t, u) =
    LSE(alpha(t-1, u) + blank(t-1, u), alpha(t, u-1) + label(t, u-1)),
    ll = alpha(T-1, U) + blank(T-1, U), solved one anti-diagonal at a time
    in float64.  lp_blank (B, T, U+1), lp_label (B, T, U)."""
    lb, ll_ = lp_blank.double(), lp_label.double()
    B, T, U1 = lb.shape
    dev = lb.device
    neg = torch.tensor(-1e30, dtype=torch.float64, device=dev)
    prev = None  # alpha on diagonal n - 1, indexed by u (length U1)
    finals = torch.full((B,), -1e30, dtype=torch.float64, device=dev)
    rows = torch.arange(B, device=dev)
    t_end, u_end = elens.long() - 1, ylens.long()
    u_idx = torch.arange(U1, device=dev)
    for n in range(T + U1 - 1):
        t = n - u_idx  # (U1,)
        inside = (t >= 0) & (t < T)
        tc = t.clamp(0, T - 1)
        if prev is None:
            cur = torch.where(u_idx == 0, torch.zeros((), dtype=torch.float64, device=dev), neg).expand(B, U1)
        else:
            # from (t-1, u) by blank: prev[u] (t-1 = n-1-u)
            tb = (t - 1).clamp(0, T - 1)
            from_blank = torch.where((t >= 1)[None], prev + lb[:, tb, u_idx], neg)
            # from (t, u-1) by label: prev[u-1] (t = n-1-(u-1))
            um = (u_idx - 1).clamp(min=0)
            from_label = torch.where((u_idx >= 1)[None], prev[:, um] + ll_[:, tc, um.clamp(max=U1 - 2)], neg)
            cur = torch.logaddexp(from_blank, from_label)
        cur = torch.where(inside[None], cur, neg)
        fin = cur[rows, u_end.clamp(max=U1 - 1)] + lb[rows, t_end.clamp(0, T - 1), u_end.clamp(max=U1 - 1)]
        finals = torch.where((t_end + u_end) == n, fin, finals)
        prev = cur
    return finals


# ---------------------------------------------------------------------------
# optimisation
# ---------------------------------------------------------------------------


def noam_lr(cfg: dict, step: int) -> float:
    s = max(float(step), 1.0)
    return cfg["learning_rate"] * cfg["enc_hidden_size"] ** -0.5 * min(s ** -0.5, s * cfg["num_warmup_steps"] ** -1.5)


class Adam:
    """Adam (Kingma & Ba) with L2 weight decay added to the gradient,
    b1 0.9, b2 0.999, eps 1e-8; `update` returns the gradient it took."""

    def __init__(self, params: Dict[str, torch.Tensor], wd: float):
        self.p = params
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t, self.wd = 0, wd

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], lr: float) -> Dict[str, torch.Tensor]:
        self.t += 1
        b1, b2 = 0.9, 0.999
        taken = {}
        for k, p in self.p.items():
            g = grads[k] + self.wd * p
            taken[k] = g
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k] / (1 - b2 ** self.t)).sqrt() + 1e-8
            p.sub_(lr / (1 - b1 ** self.t) * self.m[k] / denom)
        return taken


def clip_(grads: Sequence[torch.Tensor], max_norm: float) -> None:
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
    if float(norm) >= max_norm:
        for g in grads:
            g.mul_(float(max_norm / norm))


def train_reference(model: nn.Module, loss_fn, batches: List[dict], cfg: dict, seeds: dict,
                    updates: int) -> dict:
    """Follow the program's first `updates` optimizer steps: `accum_grad`
    micro-steps each (their gradients averaged, clipped by the global norm,
    then Adam at the noam LR of the update).  `loss_fn(model, batch,
    sa_gen, attn_drop)` -> the batch's loss.  Returns each micro-step's
    loss, the gradient Adam took in the first update and the parameters
    after the last (by name)."""
    accum = int(cfg["accum_grad"])
    dev = next(model.parameters()).device
    torch.manual_seed(seeds["dropout"])
    sa_gen = torch.Generator(device=dev)
    sa_gen.manual_seed(seeds["specaug"])
    drop = AttentionDropout(seeds["attention"], float(cfg["dropout_attn_rate"]))
    params = dict(model.named_parameters())
    opt = Adam(params, float(cfg["weight_decay"]))
    model.train()
    losses, first_grad = [], None
    acc = {k: torch.zeros_like(p) for k, p in params.items()}
    for i in range(updates * accum):
        loss = loss_fn(model, batches[i], sa_gen, drop)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                if g is not None:
                    acc[k] += g
            if (i + 1) % accum == 0:
                for g in acc.values():
                    g /= accum
                clip_(list(acc.values()), float(cfg["clip_grad_norm"]))
                taken = opt.update(acc, noam_lr(cfg, (i + 1) // accum))
                if first_grad is None:
                    first_grad = {k: g.clone() for k, g in taken.items()}
                acc = {k: torch.zeros_like(p) for k, p in params.items()}
    return {"losses": losses, "first_grad": first_grad,
            "params": {k: p.detach().clone() for k, p in params.items()}}
