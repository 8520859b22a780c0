"""SentencePiece-style (SPM) tokenizer: greedy best-score bigram merging with
byte fallback. Semantics parity with reference llm_tokenizer_spm
(src/llama-vocab.cpp:110-279): symbols start as UTF-8 characters; the bigram
whose merged string has the highest vocab score merges first (ties: leftmost);
unmatched symbols fall back to <0xXX> byte tokens.
"""

from __future__ import annotations

import heapq

from .vocab import Vocab

SPM_WS = "▁"  # ▁


class SPMTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab

    def encode_fragment(self, text: str) -> list[int]:
        v = self.vocab
        if not text:
            return []
        text = text.replace(" ", SPM_WS)
        # symbols: (start, end) into the char list
        chars = list(text)
        n = len(chars)
        if n == 0:
            return []
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        seg_text = chars[:]  # per-symbol current text (None if merged away)
        alive = [True] * n

        def bigram(li: int):
            ri = nxt[li]
            if ri >= n:
                return None
            merged = seg_text[li] + seg_text[ri]
            tid = v.token_to_id.get(merged)
            if tid is None or v.scores is None:
                return None
            return (-float(v.scores[tid]), li, merged)

        heap = []
        for i in range(n - 1):
            bg = bigram(i)
            if bg:
                heapq.heappush(heap, bg)

        while heap:
            negscore, li, merged = heapq.heappop(heap)
            if not alive[li]:
                continue
            ri = nxt[li]
            if ri >= n or not alive[ri] or seg_text[li] + seg_text[ri] != merged:
                continue  # stale entry
            seg_text[li] = merged
            alive[ri] = False
            nxt[li] = nxt[ri]
            if nxt[li] < n:
                prev[nxt[li]] = li
            for cand in (bigram(li), bigram(prev[li]) if prev[li] >= 0 else None):
                if cand:
                    heapq.heappush(heap, cand)

        out: list[int] = []
        i = 0
        while i < n:
            if alive[i]:
                self._resegment(seg_text[i], out)
                i = nxt[i]
            else:
                i += 1
        return out

    def _resegment(self, piece: str, out: list[int]):
        v = self.vocab
        tid = v.token_to_id.get(piece)
        if tid is not None:
            out.append(tid)
            return
        if len(piece) > 1:
            # try splitting back into a best-score pair (reference resegment
            # consults the rev_merge map; equivalent greedy re-split)
            best = None
            for k in range(1, len(piece)):
                l, r = piece[:k], piece[k:]
                if l in v.token_to_id and r in v.token_to_id:
                    s = float(v.scores[v.token_to_id[l]]) + float(
                        v.scores[v.token_to_id[r]]
                    ) if v.scores is not None else 0.0
                    if best is None or s > best[0]:
                        best = (s, l, r)
            if best is not None:
                self._resegment(best[1], out)
                self._resegment(best[2], out)
                return
        for b in piece.encode("utf-8"):
            bid = v.byte_token(b)
            if bid >= 0:
                out.append(bid)
            elif v.unk_id >= 0:
                out.append(v.unk_id)

    def decode_piece(self, token_id: int) -> bytes:
        v = self.vocab
        if not 0 <= token_id < len(v.tokens):  # out-of-range id: no piece
            return b""
        t = v.tokens[token_id]
        if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
            try:
                return bytes([int(t[3:5], 16)])
            except ValueError:
                pass
        return t.replace(SPM_WS, " ").encode("utf-8")
