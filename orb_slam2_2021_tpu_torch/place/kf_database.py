"""Keyframe database: inverted file + loop / relocalization candidates
(counterpart of orb_slam2_2021_tpu/place/kf_database.py).

Host-side replacement for KeyFrameDatabase: word -> keyframe inverted file;
DetectLoopCandidates with the reference's three-stage policy (shared-word
prefilter at 0.8*max, min-score gate, accumulated covisibility-group score
with 0.75*best cut) and DetectRelocalizationCandidates (same minus the
min-score gate). The port keeps its own copy because the reference's module
cannot be imported without JAX; dict and list insertion orders are the
reference's, since the candidate order decides which candidate is tried
first.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Set, Tuple

import numpy as np

from .vocab import BinaryVocabulary, bow_vector, l1_score


class KeyFrameDatabase:
    def __init__(self, voc: BinaryVocabulary):
        self.voc = voc
        self.inverted: Dict[int, List[int]] = defaultdict(list)
        # per-KF sparse BoW: kf -> (word_ids, weights)
        self.bow: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self.words: Dict[int, np.ndarray] = {}

    # ------------------------------------------------------------------
    def add(self, kf: int, words: np.ndarray):
        """KeyFrameDatabase::add. words: [N] (-1 = invalid)."""
        self.add_bow(kf, words)
        self.add_to_index(kf)

    def add_bow(self, kf: int, words: np.ndarray):
        """Store the BoW vector only (scoring works, the KF is not yet a
        retrieval candidate — DetectLoop adds to the inverted file at the
        end)."""
        w, v = bow_vector(words, self.voc.word_idf, self.voc.n_words)
        self.bow[kf] = (w, v)
        self.words[kf] = w

    def add_to_index(self, kf: int):
        for word in self.bow[kf][0]:
            self.inverted[int(word)].append(kf)

    def erase(self, kf: int):
        """KeyFrameDatabase::erase."""
        if kf not in self.bow:
            return
        for word in self.bow[kf][0]:
            lst = self.inverted.get(int(word))
            if lst and kf in lst:
                lst.remove(kf)
        del self.bow[kf]
        del self.words[kf]

    def clear(self):
        self.inverted.clear()
        self.bow.clear()
        self.words.clear()

    # ------------------------------------------------------------------
    def score(self, kf1: int, kf2: int) -> float:
        w1, v1 = self.bow[kf1]
        w2, v2 = self.bow[kf2]
        return l1_score(w1, v1, w2, v2)

    def score_query(self, query_bow, kf: int) -> float:
        w2, v2 = self.bow[kf]
        return l1_score(query_bow[0], query_bow[1], w2, v2)

    # ------------------------------------------------------------------
    def _shared_word_counts(self, words: np.ndarray, exclude: Set[int]) -> Dict[int, int]:
        counts: Dict[int, int] = defaultdict(int)
        for word in np.unique(words[words >= 0]):
            for kf in self.inverted.get(int(word), ()):
                if kf not in exclude:
                    counts[kf] += 1
        return counts

    def detect_loop_candidates(
        self, kf: int, min_score: float, connected: Set[int], covis_fn
    ) -> List[int]:
        """DetectLoopCandidates. `connected` = covisible KFs of kf
        (excluded); covis_fn(k) -> iterable of best covisible KFs (for the
        accumulated-group score)."""
        words = self.words.get(kf)
        if words is None or len(words) == 0:
            return []
        exclude = set(connected) | {kf}
        counts = self._shared_word_counts(words, exclude)
        if not counts:
            return []
        max_common = max(counts.values())
        min_common = 0.8 * max_common
        # stage 1: shared words + min_score
        scored = []
        for k2, c in counts.items():
            if c > min_common:
                s = self.score(kf, k2)
                if s >= min_score:
                    scored.append((k2, s))
        if not scored:
            return []
        # stage 2: accumulate score over covisibility groups (top-10 covis)
        best_acc = 0.0
        acc_list = []
        score_of = dict(scored)
        for k2, s in scored:
            acc = s
            best_kf, best_s = k2, s
            for nb in covis_fn(k2):
                nb = int(nb)
                if nb in score_of and counts.get(nb, 0) > min_common:
                    acc += score_of[nb]
                    if score_of[nb] > best_s:
                        best_kf, best_s = nb, score_of[nb]
            acc_list.append((acc, best_kf))
            best_acc = max(best_acc, acc)
        # stage 3: keep group-best KFs with acc > 0.75 * best
        th = 0.75 * best_acc
        out, seen = [], set()
        for acc, k2 in acc_list:
            if acc > th and k2 not in seen:
                seen.add(k2)
                out.append(k2)
        return out

    def detect_reloc_candidates(self, words: np.ndarray, covis_fn) -> List[int]:
        """DetectRelocalizationCandidates: same policy without the
        min-score gate, for a plain (non-keyframe) query."""
        if words is None or (words >= 0).sum() == 0:
            return []
        counts = self._shared_word_counts(words, set())
        if not counts:
            return []
        max_common = max(counts.values())
        min_common = 0.8 * max_common
        qbow = bow_vector(words, self.voc.word_idf, self.voc.n_words)
        scored = {
            k2: self.score_query(qbow, k2)
            for k2, c in counts.items()
            if c > min_common
        }
        if not scored:
            return []
        best_acc = 0.0
        acc_list = []
        for k2, s in scored.items():
            acc, best_kf, best_s = s, k2, s
            for nb in covis_fn(k2):
                nb = int(nb)
                if nb in scored:
                    acc += scored[nb]
                    if scored[nb] > best_s:
                        best_kf, best_s = nb, scored[nb]
            acc_list.append((acc, best_kf))
            best_acc = max(best_acc, acc)
        th = 0.75 * best_acc
        out, seen = [], set()
        for acc, k2 in acc_list:
            if acc > th and k2 not in seen:
                seen.add(k2)
                out.append(k2)
        return out
