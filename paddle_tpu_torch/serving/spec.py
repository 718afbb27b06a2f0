"""Speculative decoding: prompt-lookup (n-gram) drafting and batched
verification, in PyTorch.

- **`NgramDrafter`** (host side, no draft model) proposes up to
  ``num_spec_tokens`` continuation candidates for a decoding sequence by
  matching its most recent n-gram suffix against its own history.
- **verification math** (device side): `spec_emit_arrays` turns one step's
  scored logits into each row's leading-accept run length and its emitted
  run. Greedy: drafted token j is accepted iff it equals the argmax at
  position j-1, so the emitted run equals sequential greedy decode.
  Sampling: rejection sampling against the temperature / top-k / top-p
  processed distribution with the point-mass proposal of the n-gram draft.

The decision is branch-free, as the JAX program computes it: one body
serves greedy and sampled rows alike (greedy rows take the argmax through
the `torch.where`s), nothing is read back to the host, and a CUDA graph
can capture it. The JAX program skips the vocab sort behind a
``lax.cond`` on a device predicate; here the sort always runs. Random
draws come from a `torch.Generator`; categorical samples are Gumbel-max.
"""
from __future__ import annotations

import math

import torch


class NgramDrafter:
    """Prompt-lookup drafting: match the sequence's recent suffix against
    its own history and propose what followed the previous occurrence.

    For n from ``max_ngram`` down to ``min_ngram``: take the last n tokens
    of prompt+outputs, find the most recent earlier occurrence of that
    n-gram WITH a full ``max_tokens`` continuation, and propose the tokens
    that followed it. Longer n-grams are tried first (a longer context
    match is a better predictor). Matches too close to the sequence end
    to supply a full draft are only a fallback: on cyclic output — the
    dominant accepting regime — the nearest match sits just before the
    suffix and would truncate the draft to a token or two, while a match
    one period further back drafts the whole window (the verify step pays
    its full ``1 + num_spec`` width either way, so short drafts waste
    it). Returns ``[]`` when nothing matches — the row then runs as a
    plain decode row, so drafting can never slow a sequence down by more
    than the (amortized) verify-width cost.
    """

    def __init__(self, num_spec_tokens=4, max_ngram=3, min_ngram=1):
        self.num_spec_tokens = int(num_spec_tokens)
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        if self.num_spec_tokens < 1:
            raise ValueError("num_spec_tokens must be >= 1")
        if not 1 <= self.min_ngram <= self.max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")

    def propose(self, all_ids, max_tokens=None):
        """Drafted continuation of `all_ids` (list of ints), at most
        ``min(max_tokens, num_spec_tokens)`` tokens; ``[]`` on no match.

        The match itself is vectorized: per n-gram size, n shifted
        numpy comparisons AND-ed over all candidate start positions —
        this runs once per decode row per step, so a Python loop over a
        multi-thousand-token history would put O(L) interpreter work on
        the host path that speculation exists to shorten."""
        import numpy as np

        cap = self.num_spec_tokens
        if max_tokens is not None:
            cap = min(cap, int(max_tokens))
        L = len(all_ids)
        if cap < 1 or L < self.min_ngram + 1:
            return []
        arr = np.asarray(all_ids, np.int64)
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            suffix = arr[L - n:]
            # candidate starts i in [0, L-n-1]: i + n <= L - 1 guarantees
            # at least one continuation token exists
            m = np.ones(L - n, bool)
            for j in range(n):
                m &= arr[j:j + L - n] == suffix[j]
            hits = np.flatnonzero(m)
            if not hits.size:
                continue
            # most recent match with a FULL draft window; a match too
            # close to the end (truncated draft) only as a fallback
            full = hits[hits + n + cap <= L]
            i = int(full[-1] if full.size else hits[-1])
            return arr[i + n:i + n + cap].tolist()
        return []


def apply_top_k_top_p(scaled, top_ks, top_ps):
    """Mask `scaled` logits ``[..., V]`` to the per-row top-k / nucleus
    top-p support. ``top_ks`` (int, 0 = off) and ``top_ps`` (float, 1.0 =
    off) broadcast against ``scaled[..., 0]``. Top-k keeps the k largest
    logits (ties at the k-th value all survive); top-p keeps the smallest
    set of tokens whose descending-probability cumsum reaches p (ties at
    the cutoff survive). The top-1 token always survives both; a row
    with both knobs off comes back unchanged."""
    V = scaled.shape[-1]
    lead = scaled.shape[:-1]
    tk = top_ks[..., None].long().expand(*lead, 1)
    tp = top_ps[..., None].expand(*lead, 1)
    # ONE descending sort serves both filters (softmax is monotone)
    svals = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(svals, -1, (tk - 1).clamp(0, V - 1))
    k_active = (tk > 0) & (tk < V)
    neg_inf = torch.full_like(scaled, -math.inf)
    scaled = torch.where(k_active & (scaled < kth), neg_inf, scaled)
    # nucleus over the top-k survivors: positions past k in the sorted
    # order drop out of the softmax/cumsum
    in_k = ~k_active | (torch.arange(V, device=scaled.device) < tk)
    sp = torch.softmax(torch.where(in_k, svals, neg_inf), dim=-1)
    csum = torch.cumsum(sp, dim=-1)
    # the LOGIT of the last token inside the nucleus: the first index where
    # the cumulative mass reaches p; when the fp32 cumsum tops out below p
    # the cut falls to the last position (keep everything)
    reached = csum >= tp
    first = torch.argmax(reached.to(torch.int32), dim=-1, keepdim=True)
    cut_idx = torch.where(reached.any(dim=-1, keepdim=True), first,
                          torch.full_like(first, V - 1))
    cut_logit = torch.gather(svals, -1, cut_idx)
    return torch.where((tp < 1.0) & (scaled < cut_logit), neg_inf, scaled)


def _categorical(logits, generator):
    """One sample per row of `logits` [..., V] by Gumbel-max."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_(torch.finfo(u.dtype).tiny, 1.0)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def spec_accept_arrays(logits, ids, spec_lens, temps, top_ks, top_ps,
                       generator=None):
    """Verify-step accept/emit math.

      logits    [B, S, V] — model logits at the S scored positions
      ids       [B, S] int — fed tokens: ``ids[:, 0]`` is the pending
                token, ``ids[:, 1:]`` the drafted candidates
      spec_lens [B] int — live drafted tokens per row (0 = plain decode)
      temps/top_ks/top_ps [B] — per-row sampling knobs
      generator — the `torch.Generator` for sampling draws (every call
                draws, also when no row samples)

    Returns ``(accept [B, S-1] bool, out_tok [B, S] int32)``: whether
    drafted token ``ids[:, j+1]`` survives at slot j, and the token to emit
    where the accepted run stops at slot j."""
    B, S, V = logits.shape
    lg = logits.float()
    greedy = torch.argmax(lg, dim=-1)                  # [B, S]
    drafts = ids[:, 1:].long()                         # [B, S-1]
    scaled = lg / temps.clamp_min(1e-6)[:, None, None]
    scaled = apply_top_k_top_p(scaled, top_ks[:, None], top_ps[:, None])
    probs = torch.softmax(scaled, dim=-1)
    p_draft = torch.gather(probs[:, :-1], -1, drafts[..., None])[..., 0]
    u = torch.rand((B, S - 1), generator=generator, device=lg.device)
    sampling = temps[:, None] > 0.0
    accept = torch.where(sampling, u < p_draft, drafts == greedy[:, :-1])
    # residual for a rejection at slot j: p with the drafted token zeroed
    resid = probs[:, :-1].scatter(-1, drafts[..., None], 0.0)
    resid_tok = _categorical(torch.log(resid), generator)
    full_tok = _categorical(torch.log(probs), generator)
    # the bonus slot (every live draft accepted) samples the full
    # distribution, rejection slots the residual
    is_bonus = (torch.arange(S, device=lg.device)[None, :]
                >= spec_lens[:, None])
    sample_tok = torch.where(
        is_bonus, full_tok, torch.cat([resid_tok, full_tok[:, -1:]], dim=1))
    out_tok = torch.where(sampling, sample_tok, greedy)
    return accept, out_tok.to(torch.int32)


def spec_emit_arrays(logits, ids, spec_lens, temps, top_ks, top_ps,
                     generator=None):
    """The accept/rollback decision on the device: `spec_accept_arrays`
    plus the leading-accept walk. Returns ``(run [B, S] int32, n_acc [B]
    int32)``: ``n_acc`` is each row's leading-accept run length and
    ``run[:, :n_acc + 1]`` the emitted run (accepted drafts, then the
    stop-slot token). With ``spec_lens == 0`` this is the one-token
    sampler: ``n_acc == 0`` and ``run[:, 0]`` is the sample."""
    B, S, _ = logits.shape
    accept, out_tok = spec_accept_arrays(
        logits, ids, spec_lens, temps, top_ks, top_ps, generator=generator)
    dev = logits.device
    if S > 1:
        j = torch.arange(S - 1, device=dev)[None, :]
        alive = accept & (j < spec_lens[:, None])
        n_acc = torch.cumprod(alive.to(torch.int32), dim=1).sum(dim=1)
    else:
        n_acc = torch.zeros((B,), dtype=torch.int32, device=dev)
    n_acc = n_acc.to(torch.int32)
    stop_tok = torch.gather(out_tok, 1, n_acc[:, None].long())
    drafts = torch.nn.functional.pad(ids[:, 1:].to(torch.int32), (0, 1))
    run = torch.where(torch.arange(S, device=dev)[None, :] < n_acc[:, None],
                      drafts, stop_tok)
    return run.to(torch.int32), n_acc
