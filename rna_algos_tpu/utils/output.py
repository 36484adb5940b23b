"""Output formatting: dot-bracket strings and sparse probability text.

Mirrors the reference CLI output layer: `get_fold_str` (bin/centroid_fold.rs:197-207)
and `probs2str` (bin/mccaskill_algo.rs:103-113).
"""

from ..constants import UNPAIR, BASEPAIR_LEFT, BASEPAIR_RIGHT


def fold_str(basepairs, seq_len: int) -> str:
    """Dot-bracket string from (i, j) pairs (bin/centroid_fold.rs:197-207)."""
    chars = [UNPAIR] * seq_len
    for i, j in basepairs:
        chars[int(i)] = BASEPAIR_LEFT
        chars[int(j)] = BASEPAIR_RIGHT
    return "".join(chars)


def pairs_from_fold_str(s: str):
    """Inverse of fold_str (used by the eval stats module)."""
    stack = []
    pairs = []
    for i, ch in enumerate(s):
        if ch == BASEPAIR_LEFT:
            stack.append(i)
        elif ch == BASEPAIR_RIGHT:
            pairs.append((stack.pop(), i))
    return pairs


def probs2str_arrays(iv, jv, pv) -> str:
    """Vector form of probs2str; uses the native formatter when built."""
    import numpy as np

    from .._native import native

    iv = np.ascontiguousarray(iv, dtype=np.int32)
    jv = np.ascontiguousarray(jv, dtype=np.int32)
    pv = np.ascontiguousarray(pv, dtype=np.float32)
    if native is not None:
        return native.probs2str(iv, jv, pv, len(pv))
    return probs2str(zip(iv, jv, pv))


def probs2str(prob_items) -> str:
    """`i,j,p ` triple text for one record (bin/mccaskill_algo.rs:103-113).

    ``prob_items`` iterates (i, j, p). The reference iterates a hashmap (unordered);
    we emit in deterministic (i, j) order - same set of triples, stable layout.
    """
    return "".join(f"{int(i)},{int(j)},{_fmt(p)} " for i, j, p in prob_items)


def parse_triples(text):
    """Parse CLI probability text into {record_id: {(i, j): p}}.

    Inverse of the mccaskill/durbin CLI layout: ``#`` header lines, ``>id``
    record lines (an index for mccaskill, an ``i,j`` pair id for durbin) and
    ``i,j,p `` triples in any order.
    """
    import re

    out = {}
    cur = None
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith(">"):
            cur = line[1:]
            out[cur] = {}
            continue
        for tok in line.split():
            m = re.match(r"^(\d+),(\d+),([-+0-9.eENaninf]+)$", tok)
            if m is None or cur is None:
                raise ValueError(f"record {cur!r}: malformed triple {tok!r}")
            out[cur][(int(m.group(1)), int(m.group(2)))] = float(m.group(3))
    return out


def triples_max_diff(ref, got):
    """Largest |p| difference of two parse_triples results.

    Raises ValueError when the record ids or any record's pair set differ:
    a missing or extra pair is a wrong answer, not a small one."""
    if set(ref) != set(got):
        raise ValueError(
            f"record ids differ: {sorted(set(ref) ^ set(got))[:10]}"
        )
    worst = 0.0
    for rid, rpairs in ref.items():
        gpairs = got[rid]
        if set(rpairs) != set(gpairs):
            raise ValueError(
                f"record {rid}: pair sets differ: "
                f"{sorted(set(rpairs) ^ set(gpairs))[:10]}"
            )
        for key, p in rpairs.items():
            worst = max(worst, abs(p - gpairs[key]))
    return worst


def _fmt(p) -> str:
    """Rust's `{}` f32 Display: shortest positional repr that round-trips f32."""
    import numpy as np

    return np.format_float_positional(np.float32(p), unique=True, trim="-")
