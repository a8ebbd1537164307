"""GloVe word + POS one-hot vectorizer for the T2M evaluator tokens, a copy of
condmdi_tpu/data/word_vectorizer.py (pure numpy; the port keeps its own copy).

Parity: reference data_loaders/humanml/utils/word_vectorizer.py:46
(WordVectorizer over 'word/POS' tokens with the VIP-word POS overrides).
When the GloVe assets (glove/our_vab_*) are absent, `HashWordVectorizer`
supplies deterministic pseudo-GloVe vectors so the evaluator pipeline stays
runnable end-to-end (relative comparisons only — absolute FID/R-precision
numbers require the real assets + evaluator checkpoint).
"""

from __future__ import annotations

import hashlib
import pickle
from pathlib import Path

import numpy as np

POS_enumerator = {
    "VERB": 0, "NOUN": 1, "DET": 2, "ADP": 3, "NUM": 4, "AUX": 5, "PRON": 6,
    "ADJ": 7, "ADV": 8, "Loc_VIP": 9, "Body_VIP": 10, "Obj_VIP": 11,
    "Act_VIP": 12, "Desc_VIP": 13, "OTHER": 14,
}

Loc_list = ("left", "right", "clockwise", "counterclockwise", "anticlockwise",
            "forward", "back", "backward", "up", "down", "straight", "curve")
Body_list = ("arm", "chin", "foot", "feet", "face", "hand", "mouth", "leg",
             "waist", "eye", "knee", "shoulder", "thigh")
Obj_List = ("stair", "dumbbell", "chair", "window", "floor", "car", "ball",
            "handrail", "baseball", "basketball")
Act_list = ("walk", "run", "swing", "pick", "bring", "kick", "put", "squat",
            "throw", "hop", "dance", "jump", "turn", "stumble", "dance",
            "stop", "sit", "lift", "lower", "raise", "wash", "stand", "kneel",
            "stroll", "rub", "bend", "balance", "flap", "jog", "shuffle",
            "lean", "rotate", "spin", "spread", "climb")
Desc_list = ("slowly", "carefully", "fast", "careful", "slow", "quickly",
             "happy", "angry", "sad", "happily", "angrily", "sadly")

VIP_dict = {
    "Loc_VIP": Loc_list,
    "Body_VIP": Body_list,
    "Obj_VIP": Obj_List,
    "Act_VIP": Act_list,
    "Desc_VIP": Desc_list,
}

WORD_DIM = 300


def _pos_ohot(pos: str) -> np.ndarray:
    v = np.zeros(len(POS_enumerator), np.float32)
    v[POS_enumerator.get(pos, POS_enumerator["OTHER"])] = 1
    return v


def _vip_pos(word: str, pos: str) -> str:
    for key, values in VIP_dict.items():
        if word in values:
            return key
    return pos


class WordVectorizer:
    """Real GloVe-backed vectorizer (needs glove/our_vab_* assets)."""

    def __init__(self, meta_root: str | Path, prefix: str = "our_vab"):
        meta_root = Path(meta_root)
        vectors = np.load(meta_root / f"{prefix}_data.npy")
        words = pickle.load(open(meta_root / f"{prefix}_words.pkl", "rb"))
        word2idx = pickle.load(open(meta_root / f"{prefix}_idx.pkl", "rb"))
        self.word2vec = {w: vectors[word2idx[w]] for w in words}

    def __getitem__(self, item: str):
        word, pos = item.split("/")
        if word in self.word2vec:
            return self.word2vec[word], _pos_ohot(_vip_pos(word, pos))
        return self.word2vec["unk"], _pos_ohot("OTHER")


class HashWordVectorizer:
    """Deterministic pseudo-GloVe fallback with identical interface."""

    def __getitem__(self, item: str):
        word, pos = item.split("/") if "/" in item else (item, "OTHER")
        seed = int.from_bytes(hashlib.sha256(word.encode()).digest()[:8], "little")
        rng = np.random.default_rng(seed)
        vec = rng.standard_normal(WORD_DIM).astype(np.float32)
        vec /= np.linalg.norm(vec)
        return vec, _pos_ohot(_vip_pos(word, pos))


def tokens_to_embeddings(tokens_list, vectorizer, max_text_len: int = 20):
    """Token lists → padded (word_embs [B,L,300], pos_ohot [B,L,15], lens [B]).

    Replicates the sos/eos/unk padding of Text2MotionDatasetV2.__getitem__
    (dataset.py:414-423).
    """
    L = max_text_len + 2
    B = len(tokens_list)
    word = np.zeros((B, L, WORD_DIM), np.float32)
    pos = np.zeros((B, L, len(POS_enumerator)), np.float32)
    lens = np.zeros((B,), np.int32)
    for i, tokens in enumerate(tokens_list):
        tokens = list(tokens)
        if len(tokens) < max_text_len:
            toks = ["sos/OTHER"] + tokens + ["eos/OTHER"]
            lens[i] = len(toks)
            toks = toks + ["unk/OTHER"] * (L - len(toks))
        else:
            toks = ["sos/OTHER"] + tokens[:max_text_len] + ["eos/OTHER"]
            lens[i] = len(toks)
        for j, tok in enumerate(toks[:L]):
            w, p = vectorizer[tok]
            word[i, j] = w
            pos[i, j] = p
    return word, pos, lens
