"""Shared constants of the framework.

Re-creation of the reference prelude (`/root/reference/src/utils.rs:121-129`
and the `rna-ss-params` shared utils: base/pair encodings, model hyper-constants).
All DP code indexes bases as integers; `PSEUDO_BASE` doubles as the padding token so
that padded batch tensors stay score-neutral (tables carry an explicit zero row for it).
"""

# --- Base encoding (rna-ss-params utils: A,C,G,U consts) ---
A = 0
C = 1
G = 2
U = 3
NUM_BASES = 4
# Sentinel/padding base (reference utils.rs:122 `PSEUDO_BASE = U + 1`).
PSEUDO_BASE = 4
# Number of base slots in dense score tables: 4 real bases + 1 neutral pad slot.
NUM_BASES_PAD = 5

# Canonical pairs (rna-ss-params utils: AU/CG/GC/GU/UA/UG pair consts).
CANONICAL_PAIRS = ((A, U), (C, G), (G, C), (G, U), (U, A), (U, G))

# --- Model hyper-constants (rna-ss-params utils) ---
# Minimum number of unpaired bases in a hairpin loop (utils.rs:174).
MIN_HAIRPIN_LEN = 3
# Minimum span j - i + 1 for a closing pair (mccaskill_algo.rs:290,298).
MIN_SPAN_HAIRPIN_CLOSE = MIN_HAIRPIN_LEN + 2
# CONTRAfold loop length cap (utils.rs:419, mccaskill_algo.rs:32-34).
MAX_LOOP_LEN = 30
# Turner 2-loop total-length cap (mccaskill_algo.rs:308,313).
MAX_2LOOP_LEN = 30
# Turner hairpin length extrapolation bounds (utils.rs:178-184).
MAX_HAIRPIN_LEN_EXTRAPOLATION = 30
MIN_HAIRPIN_LEN_EXTRAPOLATION = 31
# CONTRAfold feature-table dims (mccaskill_algo.rs:35-36,43, utils.rs:506).
MAX_INTERIOR_SYMMETRIC = 15
MAX_INTERIOR_ASYMMETRIC = 28
MAX_INTERIOR_EXPLICIT = 4

# --- Numerics (utils.rs:121) ---
LOGSUMEXP_THRESHOLD_UPPER = 11.862479
NEG_INF = float("-inf")

# --- Probability bound property used by tests (utils.rs:127-129) ---
EPSILON = 0.001
PROB_BOUND_LOWER = -EPSILON
PROB_BOUND_UPPER = 1.0 + EPSILON

# --- Dot-bracket characters (utils.rs:123-125) ---
UNPAIR = "."
BASEPAIR_LEFT = "("
BASEPAIR_RIGHT = ")"

# Test fixture (utils.rs:126).
EXAMPLE_FASTA_FILE_PATH = "assets/sampled_trnas.fa"

# Gas constant * 310.15 K in kcal/mol: converts Turner free energies (kcal/mol)
# into dimensionless log-Boltzmann scores (score = -dG / RT).
RT = 1.98717e-3 * 310.15

# Strict ACGU mapping (reference `bytes2seq`, utils.rs:562-577, errors on anything else;
# `align_char2base`, utils.rs:746-754, maps anything else to PSEUDO_BASE).
CHAR2BASE = {
    "A": A, "a": A,
    "C": C, "c": C,
    "G": G, "g": G,
    "U": U, "u": U,
}
