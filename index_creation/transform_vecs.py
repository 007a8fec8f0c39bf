#!/usr/bin/env python3
"""word2vec .bin → text conversion (reference ``transform_vecs.py`` parity,
gensim replaced by the native parser).

    python index_creation/transform_vecs.py input.bin output.txt [max_words]
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from postgres_word2vec.utils import native_io


def main(src: str, dst: str, max_words: int | None = None) -> None:
    words, vecs = native_io.load_binary_embeddings(Path(src), max_words)
    with open(dst, "w") as f:
        f.write(f"{len(words)} {vecs.shape[1]}\n")
        for w, v in zip(words, vecs):
            f.write(w + " " + " ".join(repr(float(x)) for x in v) + "\n")
    print(f"wrote {len(words)} vectors to {dst}")


if __name__ == "__main__":
    if len(sys.argv) < 3:
        print(__doc__)
        sys.exit(1)
    main(sys.argv[1], sys.argv[2],
         int(sys.argv[3]) if len(sys.argv) > 3 else None)
