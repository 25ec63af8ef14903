"""Bag-of-binary-words vocabulary (port of `ssvio_tpu/ops/bow.py`): the
DBoW2 equivalent on dense tensors.

- The tree lives in dense tensors: node descriptors [n_nodes, 8] int32 (the
  bits of the JAX package's uint32, `ops/orb.py`), a children table
  [n_nodes, k] int32, leaf word ids [n_nodes] int32. `words_of` is a
  fixed-depth descent, `levels` rounds of (gather k child descriptors, XOR
  and popcount, argmin) over the whole descriptor batch; a descriptor that
  reaches a leaf early stays there (variable-depth trees from a text file).
- BowVectors are dense [n_words] float32 (L1-normalised TF-IDF), so scoring
  a database is one pass (`score_l1_database`).
- Training is host-side numpy, this package's own copy of the JAX
  package's code (k-means++ seeded k-majority clustering, recursing to
  depth L, IDF weights from the training documents): the same documents
  and seed give the same tree. It calls this module's `words_of`.

No vocabulary file is required: the engine trains its own from the
keyframes of the warm-up window. `load_orbvoc_text` reads the ORB-SLAM text
format for file-format parity.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from ssvio_tpu_torch.ops.orb import DESC_WORDS, hamming_distance


class Vocabulary(NamedTuple):
    """Dense vocabulary tree. Leaves carry word ids; inner nodes children."""
    node_desc: torch.Tensor    # [n_nodes, 8] int32 cluster centres
    children: torch.Tensor     # [n_nodes, k] int32 (-1 = missing child)
    word_id: torch.Tensor      # [n_nodes] int32 (-1 = inner node)
    word_weight: torch.Tensor  # [n_words] float32 IDF weights

    @property
    def n_words(self) -> int:
        return self.word_weight.shape[0]

    @property
    def k(self) -> int:
        return self.children.shape[1]

    def to(self, device) -> "Vocabulary":
        return Vocabulary(*[t.to(device) for t in self])


def _vocabulary(node_desc_u32: np.ndarray, children: np.ndarray,
                word_id: np.ndarray, word_weight: np.ndarray) -> Vocabulary:
    return Vocabulary(
        torch.from_numpy(np.ascontiguousarray(node_desc_u32, np.uint32)
                         .view(np.int32).copy()),
        torch.from_numpy(np.asarray(children, np.int32)),
        torch.from_numpy(np.asarray(word_id, np.int32)),
        torch.from_numpy(np.asarray(word_weight, np.float32)))


# ----------------------------------------------------------------------
# training (host, numpy)
# ----------------------------------------------------------------------

def _unpack_bits(desc: np.ndarray) -> np.ndarray:
    """[N, 8] uint32 -> [N, 256] uint8 bits (LSB first per word, the
    packing of ops/orb.py)."""
    bits = ((desc[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1)
    return bits.reshape(desc.shape[0], -1).astype(np.uint8)


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """[N, 256] {0,1} -> [N, 8] uint32."""
    b = bits.reshape(bits.shape[0], DESC_WORDS, 32).astype(np.uint32)
    return (b << np.arange(32, dtype=np.uint32)).sum(axis=2, dtype=np.uint32)


def _hamming_np(bits: np.ndarray, centers_bits: np.ndarray) -> np.ndarray:
    """[N, 256] x [K, 256] -> [N, K] int32 Hamming distances (as a matrix
    product: d = sum(b) + sum(c) - 2 b.c)."""
    b = bits.astype(np.float32)
    c = centers_bits.astype(np.float32)
    return (b.sum(1, keepdims=True) + c.sum(1)[None, :]
            - 2.0 * (b @ c.T)).astype(np.int32)


def _kmajority(bits: np.ndarray, k: int, rng: np.random.Generator,
               iters: int = 8):
    """Binary k-means: k-means++ init, majority-vote centres.
    Returns (centers_bits [k', 256], assign [N]); k' <= k."""
    n = bits.shape[0]
    k = min(k, n)
    first = rng.integers(n)
    centers = [bits[first]]
    d_min = _hamming_np(bits, np.array(centers))[:, 0].astype(np.float64)
    for _ in range(1, k):
        p = d_min ** 2
        s = p.sum()
        idx = rng.integers(n) if s <= 0 else rng.choice(n, p=p / s)
        centers.append(bits[idx])
        d_new = _hamming_np(bits, bits[idx][None])[:, 0]
        d_min = np.minimum(d_min, d_new)
    centers = np.array(centers)
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d = _hamming_np(bits, centers)
        assign = d.argmin(1)
        for c in range(len(centers)):
            m = assign == c
            if m.any():
                centers[c] = (bits[m].mean(0) > 0.5).astype(np.uint8)
            else:  # dead cluster: reseed at the farthest point
                far = d.min(1).argmax()
                centers[c] = bits[far]
    d = _hamming_np(bits, centers)
    return centers, d.argmin(1)


def train(documents: Sequence[np.ndarray], k: int = 10, levels: int = 3,
          seed: int = 7, max_train_descriptors: int = 120_000) -> Vocabulary:
    """Build a vocabulary from per-image descriptor sets.

    documents: list of [Ni, 8] uint32 numpy arrays (one per training
      image; `interop.descriptors_numpy` gives them from the port's int32).
    k, levels: branching factor and depth (k=10 L=3: up to 1000 words).
    Returns a Vocabulary of CPU tensors (`.to(device)` moves it)."""
    rng = np.random.default_rng(seed)
    all_desc = np.concatenate([d for d in documents if len(d)], axis=0)
    if len(all_desc) > max_train_descriptors:
        sel = rng.choice(len(all_desc), max_train_descriptors, replace=False)
        all_desc = all_desc[sel]
    bits = _unpack_bits(all_desc)

    node_desc: List[np.ndarray] = [np.zeros(DESC_WORDS, np.uint32)]  # root
    children: List[List[int]] = [[]]
    word_of_node: List[int] = [-1]
    n_words = 0

    def build(subset: np.ndarray, node: int, level: int):
        nonlocal n_words
        if level == levels or len(subset) <= 1:
            word_of_node[node] = n_words
            n_words += 1
            return
        centers, assign = _kmajority(subset, k, rng)
        for c in range(len(centers)):
            child = len(node_desc)
            node_desc.append(_pack_bits(centers[c][None])[0])
            children.append([])
            word_of_node.append(-1)
            children[node].append(child)
            sub = subset[assign == c]
            build(sub if len(sub) else centers[c][None], child, level + 1)

    build(bits, 0, 0)

    n_nodes = len(node_desc)
    child_tab = np.full((n_nodes, k), -1, np.int32)
    for i, ch in enumerate(children):
        child_tab[i, :len(ch)] = ch
    word_id = np.array(word_of_node, np.int32)

    # IDF from the training documents: idf(w) = log(N_docs / n_docs(w))
    vocab = _vocabulary(np.array(node_desc), child_tab, word_id,
                        np.ones((n_words,), np.float32))
    n_docs = max(1, len(documents))
    seen = np.zeros(n_words, np.int64)
    for d in documents:
        if not len(d):
            continue
        d32 = torch.from_numpy(np.ascontiguousarray(d, np.uint32)
                               .view(np.int32))
        w = words_of(vocab, d32, torch.ones(len(d), dtype=torch.bool),
                     levels).numpy()
        seen[np.unique(w[w >= 0])] += 1
    idf = np.log(n_docs / np.maximum(seen, 1).astype(np.float64))
    # words never seen in training keep weight log(n_docs) (max rarity)
    return vocab._replace(
        word_weight=torch.from_numpy(idf.astype(np.float32)))


# ----------------------------------------------------------------------
# transform + scoring (device)
# ----------------------------------------------------------------------

def words_of(vocab: Vocabulary, desc: torch.Tensor, valid: torch.Tensor,
             levels: int) -> torch.Tensor:
    """Tree descent: [N, 8] int32 -> word id per descriptor [N] int32 (-1
    for invalid). Among children at equal distance the first wins."""
    cur = torch.zeros((desc.shape[0],), dtype=torch.long,
                      device=desc.device)                  # root
    for _ in range(levels):
        kids = vocab.children[cur].long()                  # [N, k]
        kd = vocab.node_desc[torch.clamp(kids, min=0)]     # [N, k, 8]
        d = hamming_distance(desc[:, None, :], kd)         # [N, k]
        d = torch.where(kids >= 0, d, torch.full_like(d, 1 << 20))
        best = torch.gather(kids, 1,
                            torch.argmin(d, dim=1)[:, None])[:, 0]
        at_leaf = vocab.children[cur, 0] < 0
        cur = torch.where(at_leaf, cur, best)
    return torch.where(valid, vocab.word_id[cur],
                       torch.full_like(vocab.word_id[cur], -1))


def transform(vocab: Vocabulary, desc: torch.Tensor, valid: torch.Tensor,
              levels: int) -> torch.Tensor:
    """[N, 8] descriptors -> dense L1-normalised TF-IDF BowVector
    [n_words]. The term counts are whole numbers, so the order of the
    scatter-add's atomics on the card does not change them."""
    w = words_of(vocab, desc, valid, levels)
    tf = torch.zeros((vocab.n_words,), dtype=torch.float32,
                     device=desc.device)
    tf.index_add_(0, torch.clamp(w, min=0).long(),
                  (w >= 0).to(torch.float32))
    v = tf * vocab.word_weight
    return v / torch.clamp(torch.sum(torch.abs(v)), min=1e-12)


def score_l1(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score: 1 - 0.5 |v1 - v2|_1 for L1-normalised vectors."""
    return 1.0 - 0.5 * torch.sum(torch.abs(v1 - v2), dim=-1)


def score_l1_database(v: torch.Tensor, db: torch.Tensor,
                      db_valid: torch.Tensor) -> torch.Tensor:
    """Score one BowVector against the whole database in one pass.
    v [W], db [D, W], db_valid [D] -> scores [D] (-1 for invalid rows)."""
    s = 1.0 - 0.5 * torch.sum(torch.abs(db - v[None, :]), dim=-1)
    return torch.where(db_valid, s, torch.full_like(s, -1.0))


# ----------------------------------------------------------------------
# ORB-SLAM text-format loader
# ----------------------------------------------------------------------

def load_orbvoc_text(path: str) -> Vocabulary:
    """Parse an ORBvoc.txt-style vocabulary.

    Line 1: `k L scoring_type weighting_type`; then one line per non-root
    node: `parent_id is_leaf b0 ... b31 weight` in tree order. Descriptors
    loaded this way mean something only where the engine's descriptors use
    the same BRIEF pattern (Settings.brief_pattern_path)."""
    with open(path, "r") as f:
        header = f.readline().split()
        k = int(header[0])
        parents: List[int] = [-1]
        is_leaf: List[bool] = [False]
        descs: List[np.ndarray] = [np.zeros(32, np.uint8)]
        weights: List[float] = [0.0]
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            is_leaf.append(bool(int(parts[1])))
            descs.append(np.array([int(x) for x in parts[2:34]], np.uint8))
            weights.append(float(parts[34]))

    n = len(parents)
    child_tab = np.full((n, k), -1, np.int32)
    counts = np.zeros(n, np.int32)
    for i in range(1, n):
        p = parents[i]
        child_tab[p, counts[p]] = i
        counts[p] += 1
    word_id = np.full(n, -1, np.int32)
    wword: List[float] = []
    for i in range(n):
        if is_leaf[i]:
            word_id[i] = len(wword)
            wword.append(weights[i])
    packed = np.frombuffer(np.array(descs, np.uint8).tobytes(),
                           np.uint32).reshape(n, DESC_WORDS)
    return _vocabulary(packed, child_tab, word_id,
                       np.array(wword, np.float32))


def tree_depth(vocab: Vocabulary) -> int:
    """Max root->leaf depth of a (possibly variable-depth) tree: the
    descent rounds `transform` needs for a loaded vocabulary."""
    children = vocab.children.cpu().numpy()
    depth = 0
    frontier = np.array([0], np.int32)
    while frontier.size:
        kids = children[frontier].reshape(-1)
        frontier = kids[kids >= 0]
        if frontier.size:
            depth += 1
        if depth > 64:
            raise ValueError("vocabulary tree deeper than 64 (cycle?)")
    return depth
