"""Sequence encoding and input generation.

The reference operates on raw ``char*`` ACGT strings (serial_smithW.c:64,87-88)
and generates random inputs with libc ``rand()%4`` (serial_smithW.c:334-361 —
note the serial version never seeds, so its "random" inputs are deterministic;
the OpenMP versions seed with time(NULL), omp_smithW.c:491).

Here sequences are int8 code arrays (A,C,G,T -> 0..3) so substitution
scoring is a vector compare (DNA) or a lookup in a substitution table
(proteins).
"""

from __future__ import annotations

import numpy as np

DNA_ALPHABET = "ACGT"
_CODE = {c: i for i, c in enumerate(DNA_ALPHABET)}

# 20 amino acids + X, for the protein/BLOSUM extension path.
PROTEIN_ALPHABET = "ARNDCQEGHILKMFPSTWYVX"


def encode(seq: str, alphabet: str = DNA_ALPHABET) -> np.ndarray:
    """String -> int8 codes. Unknown characters raise."""
    lut = {c: i for i, c in enumerate(alphabet)}
    try:
        return np.array([lut[c] for c in seq], dtype=np.int8)
    except KeyError as e:
        raise ValueError(f"character {e} not in alphabet {alphabet!r}") from None


def decode(codes: np.ndarray, alphabet: str = DNA_ALPHABET) -> str:
    """Codes -> text. Negative codes (the -1 unknown-base sentinel from
    the file readers, and padding sentinels) render as 'N' ('X' for
    protein alphabets that carry one) — Python's negative indexing would
    otherwise silently print the LAST alphabet letter ('T' for DNA)."""
    unk = "X" if "X" in alphabet else "N"
    return "".join(alphabet[int(c)] if c >= 0 else unk for c in codes)


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of UNPADDED DNA codes (A<->T is 0<->3, C<->G is
    1<->2, i.e. ``3 - code``); negative sentinel codes keep their value but
    move with the reversal, so on a `pad_queries` row the trailing pad
    would land at the FRONT and shift read coordinates — reverse padded
    batches with `dist.database.revcomp_padded` instead. DNA-only by
    construction — do not use with protein codes."""
    codes = np.asarray(codes, np.int8)
    out = np.where(codes >= 0, 3 - codes, codes).astype(np.int8)
    return out[..., ::-1]


def random_pair(m: int, n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Random ACGT pair: a has length m (columns), b length n (rows).

    Matches the reference's uniform-over-4-letters generator
    (serial_smithW.c:334-361) but with an explicit, reproducible seed.
    """
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, size=m, dtype=np.int8)
    b = rng.integers(0, 4, size=n, dtype=np.int8)
    return a, b


def random_batch(batch: int, m: int, n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Batch of random pairs, shapes (batch, m) and (batch, n)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, size=(batch, m), dtype=np.int8)
    b = rng.integers(0, 4, size=(batch, n), dtype=np.int8)
    return a, b


class GlibcRand:
    """Bit-exact emulation of glibc's TYPE_3 additive-feedback ``rand()``.

    The reference's serial generator never calls ``srand`` (serial_smithW.c:334
    has no seeding), so glibc uses seed 1 and its input stream is fully
    deterministic. Emulating it lets tests reproduce the exact byte streams a
    reference binary would align, for cross-validation without running C code.
    """

    def __init__(self, seed: int = 1):
        # glibc initstate for TYPE_3: r[0]=seed; r[i] = 16807*r[i-1] % 2^31-1
        # computed with the Schrage trick; then r[i+31]=r[i], r[i+34]=r[i+3]
        # style warm-up of 310 discarded outputs.
        r = [0] * 344
        r[0] = seed
        for i in range(1, 31):
            hi, lo = divmod(r[i - 1], 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344):
            r[i] = (r[i - 31] + r[i - 3]) & 0xFFFFFFFF
        self._r = r
        self._idx = 344

    def rand(self) -> int:
        r = self._r
        i = self._idx
        val = (r[i - 31] + r[i - 3]) & 0xFFFFFFFF
        r.append(val)
        self._idx = i + 1
        return val >> 1

    def reference_sequence(self, length: int) -> np.ndarray:
        """int8 codes matching the reference generate() letter mapping:
        rand%4 -> 0:'A' 2:'C' 3:'G' else(1):'T' (serial_smithW.c:337-346)."""
        out = np.empty(length, dtype=np.int8)
        remap = {0: 0, 2: 1, 3: 2, 1: 3}  # letter -> our ACGT code
        for i in range(length):
            out[i] = remap[self.rand() % 4]
        return out
