"""Shape bucketing: stable jit shapes across sub-blocks.

Every distinct (R, L) pair compiles a fresh XLA executable; sub-blocks differ
slightly in record count (byte-based splits, last sub-block, per-writer
remainders), so un-bucketed shapes trigger a recompile storm (observed: 4
writers → 4× compiles of every kernel). Padded records have zero length and
emit zero bits; true counts travel in the meta section.
"""

from __future__ import annotations


def bucket_records(R: int, G: int, shards: int = 1) -> int:
    """Round the record axis up to a power of two (min 512), then to a
    multiple of the substream width G (× the data-shard count, so shard
    boundaries align with substream boundaries)."""
    Rp = max(R, 512)
    Rp = 1 << (Rp - 1).bit_length()
    m = G * max(shards, 1)
    return Rp + ((-Rp) % m)


class BucketCtx:
    """Per-driver-run record-bucket registry: tail sub-blocks are promoted to
    an already-used bucket so one run compiles ONE executable set instead of
    one per distinct tail size (each extra bucket costs a full kernel-set
    compile). The
    promotion cap bounds wasted padding (upload bytes + device work) to one
    full-size sub-block's worth per tail. Decode follows automatically: the
    container stores the substream table, so decode shapes mirror encode's.

    Scoped to one driver run (not module-global) so independent compressions
    stay deterministic: output depends only on (cfg, input)."""

    #: promote only within this factor of the natural bucket
    MAX_PROMOTE = 16
    #: word-buffer promotion bound: absolute extra words (2 MiB of u32) —
    #: one bounded extra transfer per tail vs one full kernel-set compile
    MAX_PROMOTE_WORDS = 1 << 19

    def __init__(self) -> None:
        self._seen: dict = {}  # (G, shards) -> set of buckets in use
        self._words: dict = {}  # kind -> set of word-buffer sizes in use

    def pick(self, R: int, G: int, shards: int = 1) -> int:
        natural = bucket_records(R, G, shards)
        used = self._seen.setdefault((G, max(shards, 1)), set())
        cands = [b for b in used
                 if natural <= b <= natural * self.MAX_PROMOTE]
        chosen = min(cands) if cands else natural
        used.add(chosen)
        return chosen

    def pick_words(self, kind: str, natural: int, worst: int = 0) -> int:
        """Promote a bucketed word-buffer size (encode fetch cap / decode
        upload pad) to an already-used size of the same kind, bounding both
        the distinct static shapes per run and the per-use padding waste.
        `kind` separates streams (e.g. quality vs dna) so one stream's large
        cap never inflates the other's every sub-block."""
        used = self._words.setdefault(kind, set())
        cands = [b for b in used
                 if natural <= b <= natural + self.MAX_PROMOTE_WORDS
                 and (not worst or b <= worst)]
        chosen = min(cands) if cands else natural
        used.add(chosen)
        return chosen


def bucket_length(L: int) -> int:
    """Round the position axis to a multiple of 4 (common read lengths 36/76/
    100 are already multiples; waste is <= 3 positions otherwise)."""
    return max(4, (L + 3) // 4 * 4)
