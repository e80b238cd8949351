"""Derive visual-similarity (homoglyph) pairs from a trained index (the
JAX package's cli/build_homoglyphs.py).

    python -m effocr_torch build-homoglyphs --recognizer_dir rec_knn \
        --out homoglyphs.txt --sim_thresh 0.9

Chars whose prototype embeddings are cosine-near are exactly the
confusions the trained recognizer makes (error-analysis confirms: the en
residual is l->I / u<->n — embedding neighbors, not dictionary words).
The reference ships a hand-curated HOMOGLYPHS table
(utils/spell_check_utils.py:26-57); this derives the artifact-specific
extension the spell checker's beam search should also try:
`infer --spell_check --homoglyphs homoglyphs.txt`.

Host-side numpy over ref.npz; no device.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    import numpy as np

    from effocr_torch.retrieval.index import PrototypeIndex

    p = argparse.ArgumentParser(
        prog="python -m effocr_torch build-homoglyphs")
    p.add_argument("--recognizer_dir", type=str, required=True,
                   help="directory holding ref.npz + ref.txt")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--sim_thresh", type=float, default=0.8,
                   help="cosine similarity above which a char pair is "
                        "emitted (prototypes are L2-normalized; 0.8 won a "
                        "0.95/0.9/0.8/0.75 sweep on the en demo val split, "
                        "BENCH_ACCURACY.md)")
    p.add_argument("--max_per_char", type=int, default=4)
    p.add_argument("--block", type=int, default=2048,
                   help="row block size for the similarity matmul")
    args = p.parse_args(argv)

    index = PrototypeIndex.load(args.recognizer_dir)
    emb = np.array(index.embeddings, np.float32)  # writable copy
    emb /= np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12
    chars = list(index.chars)

    # collapse multi-row-per-char indexes: similarity between two chars =
    # max over their prototype rows
    best: dict = {}
    n = emb.shape[0]
    for lo in range(0, n, args.block):
        sims = emb[lo : lo + args.block] @ emb.T  # [b, n]
        for i in range(sims.shape[0]):
            gi = chars[lo + i]
            row = sims[i]
            for j in np.nonzero(row >= args.sim_thresh)[0]:
                gj = chars[j]
                if gj == gi:
                    continue
                key = (gi, gj) if gi < gj else (gj, gi)
                s = float(row[j])
                if s > best.get(key, 0.0):
                    best[key] = s

    per_char: dict = {}
    pairs = sorted(best.items(), key=lambda kv: -kv[1])
    kept = []
    for (a, b), s in pairs:
        if (per_char.get(a, 0) >= args.max_per_char
                or per_char.get(b, 0) >= args.max_per_char):
            continue
        per_char[a] = per_char.get(a, 0) + 1
        per_char[b] = per_char.get(b, 0) + 1
        kept.append((a, b, s))

    with open(args.out, "w", encoding="utf-8") as f:
        for a, b, s in kept:
            f.write(f"{a} {b}\n")
    print(f"{len(kept)} pairs >= cos {args.sim_thresh} -> {args.out}"
          + (f" (top: "
             + ", ".join(f"{a!r}~{b!r}:{s:.3f}" for a, b, s in kept[:6])
             + ")" if kept else ""))


if __name__ == "__main__":
    main()
