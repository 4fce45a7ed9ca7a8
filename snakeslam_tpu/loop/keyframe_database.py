"""Keyframe database: BoW retrieval for loop detection and relocalization.

Replacement for the reference's inverted-file KeyframeDatabase (reference:
Snake/LoopClosing/KeyframeDatabase.{h,cpp}).  Candidate retrieval follows
the reference pipeline exactly (KeyframeDatabase.cpp:58-170):

  1. sharing-word count over the inverted file (GetKeyframesWithSharingWords,
     :100-121) — only keyframes sharing >= 0.8 * max shared words survive;
  2. L1 tf-idf similarity on the survivors with a score-ratio filter
     (>= 0.75 * best) and the caller's adaptive min score
     (RemoveWeakMatches, :123-168);
  3. covisibility-group score accumulation: each surviving candidate's score
     is summed over its covisible group and groups are re-ranked, returning
     the best single keyframe per group (the ORB-SLAM-style accumulation the
     detector's consistency groups assume — several weak neighbors of a true
     revisit outrank one lucky unrelated hit).

Dense tf-idf vectors are kept per keyframe so the similarity of the ~10
survivors is a host-side vector op; the inverted file only does integer
counting, never scoring.
"""

from __future__ import annotations

import numpy as np

from snakeslam_tpu.map.slam_map import SlamMap
from snakeslam_tpu.ops import bow as BOW

SHARING_WORD_RATIO = 0.8    # KeyframeDatabase.cpp:71
SCORE_RATIO = 0.75          # KeyframeDatabase.cpp:71


class KeyframeDatabase:
    def __init__(self, voc: BOW.Vocabulary, smap: SlamMap):
        self.voc = voc
        self.map = smap
        self.vectors = np.zeros((smap.max_keyframes, voc.n_words),
                                dtype=np.float32)
        self.words: dict[int, np.ndarray] = {}   # kf -> unique word ids
        self.inverse: dict[int, list[int]] = {}  # word -> kf list
        self.present = np.zeros(smap.max_keyframes, dtype=bool)

    # ------------------------------------------------------------------

    def compute_frame_vector(self, desc_bits: np.ndarray):
        """(n, 256) bits OR packed (n, 32) -> (words, dense vector);
        host-side descent (the tree walk is tiny next to a blocking device
        call).  Routed through the packed XOR/popcount descent, because
        this sits on the per-keyframe back-end critical path."""
        if desc_bits.shape[-1] != 32:
            desc_bits = np.packbits(desc_bits.astype(np.uint8), axis=-1,
                                    bitorder="little")
        return BOW.transform_packed_np(self.voc, desc_bits)

    def add(self, kf: int):
        # idempotent: back-end queues legitimately re-enqueue keyframes
        # (simplification neighbor re-adds, deferred re-processing) and a
        # duplicate inverted-file entry would DOUBLE the keyframe's
        # shared-word counts — inflating max_common until the 0.8 ratio
        # filter rejects every honestly-counted candidate (this exact bug
        # silently killed loop detection on the rendered-orbit workload)
        if self.present[kf]:
            self.remove(kf)
        n = int(self.map.kf_n_feat[kf])
        words, v = BOW.transform_packed_np(
            self.voc, self.map.kf_feat_desc[kf, :n])
        uniq = np.unique(words)
        self.vectors[kf] = v
        self.words[kf] = uniq
        for w in uniq.tolist():
            self.inverse.setdefault(w, []).append(kf)
        self.present[kf] = True

    def remove(self, kf: int):
        self.present[kf] = False
        self.vectors[kf] = 0
        uniq = self.words.pop(kf, None)
        if uniq is not None:
            for w in uniq.tolist():
                lst = self.inverse.get(w)
                if lst is not None:
                    try:
                        lst.remove(kf)
                    except ValueError:
                        pass

    # ------------------------------------------------------------------

    def _shared_word_counts(self, words_q: np.ndarray) -> np.ndarray:
        """Per-keyframe count of words shared with the query (the inverted
        file walk, KeyframeDatabase.cpp:100-121)."""
        counts = np.zeros(self.map.max_keyframes, dtype=np.int32)
        hits: list[list[int]] = []
        for w in np.unique(words_q).tolist():
            lst = self.inverse.get(w)
            if lst:
                hits.append(lst)
        if hits:
            flat = np.concatenate([np.asarray(h, dtype=np.int64)
                                   for h in hits])
            np.add.at(counts, flat, 1)
        return counts

    def _filtered_scores(self, v: np.ndarray, words_q: np.ndarray,
                         active: np.ndarray):
        """Sharing-word + score-ratio filters (RemoveWeakMatches,
        KeyframeDatabase.cpp:123-168).  Returns (ids, scores); the
        caller applies its min-score policy (per-keyframe for
        relocalization, group-accumulated for loop candidates)."""
        counts = self._shared_word_counts(words_q)
        counts[~active] = 0
        max_common = int(counts.max()) if counts.size else 0
        if max_common == 0:
            return np.array([], dtype=int), np.array([])
        ids = np.nonzero(counts >= SHARING_WORD_RATIO * max_common)[0]
        # host-side L1 score (DBoW2: 1 - 0.5*|v1-v2|_1): the vectors live
        # in host memory and the dot is tiny — a device call would cost a
        # blocking dispatch + fetch
        scores = 1.0 - 0.5 * np.abs(v[None] - self.vectors[ids]).sum(axis=-1)
        best = float(scores.max()) if len(scores) else 0.0
        keep = scores >= SCORE_RATIO * best
        return ids[keep], scores[keep]

    def query(self, v: np.ndarray, words: np.ndarray | None = None,
              exclude: set[int] | None = None,
              min_score: float = 0.0, top_n: int = 5):
        """Score v against stored keyframes through the sharing-word and
        score-ratio filters; returns (kf_ids, scores) sorted descending."""
        active = self.present & self.map.kf_valid[: len(self.present)]
        if exclude:
            active = active.copy()
            active[list(exclude)] = False
        if words is None:
            # fall back to nonzero tf-idf entries as the word set
            words = np.nonzero(v)[0]
        ids, scores = self._filtered_scores(v, words, active)
        keep = scores >= min_score
        ids, scores = ids[keep], scores[keep]
        order = np.argsort(-scores)[:top_n]
        return ids[order], scores[order]

    def detect_loop_candidates(self, kf: int, min_score: float,
                               top_n: int = 5,
                               v: np.ndarray | None = None,
                               words: np.ndarray | None = None,
                               extra_exclude: set[int] | None = None):
        """Loop candidates: exclude the covisible neighborhood (and any
        caller-side exclusions, e.g. the detector's temporal-gap rule)
        BEFORE the ratio filters — exclusions must not eat the ratio
        budget (the reference removes connected keyframes from the
        sharing-word list first, KeyframeDatabase.cpp:63-69) — then rank
        surviving keyframes by their covisibility-group accumulated score
        and return the best member of each group.

        The query keyframe is usually not in the database yet (the detector
        registers it after detection, LoopClosing.cpp:29-59) — pass its
        vector/words explicitly in that case."""
        cov, _ = self.map.covisible_keyframes(kf, min_weight=1)
        exclude = set(int(c) for c in cov) | {kf}
        if extra_exclude:
            exclude |= set(int(e) for e in extra_exclude)
        if v is None:
            v = self.vectors[kf]
        if words is None:
            words = self.words.get(kf)
        active = self.present & self.map.kf_valid[: len(self.present)]
        active = active.copy()
        active[list(exclude)] = False
        if words is None:
            words = np.nonzero(v)[0]
        ids, scores = self._filtered_scores(v, words, active)
        if len(ids) == 0:
            return ids, scores
        return self._group_accumulate(ids, scores, min_score, top_n)

    def _group_accumulate(self, ids: np.ndarray, scores: np.ndarray,
                          min_score: float, top_n: int):
        """Covisibility-group score accumulation: a candidate's effective
        score is the sum over its covisible group's surviving members; the
        group's best-scoring keyframe represents it in the ranking, and the
        min-score floor applies to the ACCUMULATED score — several weak
        covisible neighbors of a true revisit jointly clear a floor that
        each alone would miss (and jointly outrank one lucky unrelated
        hit)."""
        score_of = {int(k): float(s) for k, s in zip(ids, scores)}
        best_of_group: dict[int, tuple[float, float]] = {}  # rep -> (acc, s)
        for k, s in zip(ids, scores):
            k = int(k)
            group, _ = self.map.covisible_keyframes(k, min_weight=15)
            acc = float(s)
            rep, rep_score = k, float(s)
            for g in group[:10]:
                gs = score_of.get(int(g))
                if gs is None:
                    continue
                acc += gs
                if gs > rep_score:
                    rep, rep_score = int(g), gs
            prev = best_of_group.get(rep)
            if prev is None or acc > prev[0]:
                best_of_group[rep] = (acc, rep_score)
        ranked = [(r, a) for r, (a, _) in best_of_group.items()
                  if a >= min_score]
        ranked.sort(key=lambda it: -it[1])
        out_ids = np.array([r for r, _ in ranked[:top_n]], dtype=int)
        out_scores = np.array([a for _, a in ranked[:top_n]])
        return out_ids, out_scores

    def detect_relocalization_candidates(self, frame_desc_bits: np.ndarray,
                                         top_n: int = 5):
        words, v = self.compute_frame_vector(frame_desc_bits)
        return self.query(v, words=words, exclude=None, min_score=0.0,
                          top_n=top_n)
