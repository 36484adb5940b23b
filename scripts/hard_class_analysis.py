"""Hard-class eval analysis (VERDICT r3, item 7): why does the greedy threshold arm match MEA on hard classes?

CPU-only: f64 oracle + XLA-path BPPs on representative hard-family members;
measures (a) BPP concentration on true pairs, (b) production-vs-f64-oracle
BPP agreement on true long-range pairs, (c) fine-gamma F1 sweeps for both
estimators.
"""
import os, sys, json
os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import numpy as np

from rna_algos_tpu.eval import synth
from rna_algos_tpu.eval.baseline import threshold_pairs
from rna_algos_tpu.models.centroid import centroid_fold
from rna_algos_tpu.models.mccaskill import mccaskill_bpp_batch
from rna_algos_tpu.ops import scores as S
from rna_algos_tpu.params import build_fold_score_sets
from rna_algos_tpu.parallel.runner import pick_bucket, pad_seqs
from rna_algos_tpu.utils import bytes2seq
from tests.oracle.fold_oracle_vec import mccaskill_oracle_vec
import jax.numpy as jnp

CT = S.contra_table_pytree(build_fold_score_sets())
FSS = {k: np.asarray(v) for k, v in build_fold_score_sets().items()}

def f1(pred, true):
    tp = len(set(pred) & set(true))
    if not pred or not true: return 0.0
    p = tp / len(pred); r = tp / len(true)
    return 0.0 if p + r == 0 else 2 * p * r / (p + r)

report = {"members": []}
rng = np.random.default_rng(42)
for cls, L in (("multiloop", 150), ("longrange", 160)):
    rows, ss = synth.sample_family(rng, 4, L, structure_cls=cls)
    true_pairs = synth.pair_table(ss)
    for _, seq_s in rows[:2]:
        seq_u = seq_s.replace("-", "")
        # project true pairs onto ungapped coords
        pos = [i for i, ch in enumerate(seq_s) if ch != "-"]
        inv = {p: k for k, p in enumerate(pos)}
        tp_set = [(inv[i], inv[j]) for (i, j) in true_pairs
                  if i in inv and j in inv]
        iseq = np.asarray(bytes2seq(seq_u), dtype=np.int32)
        n = len(iseq)
        # production BPPs (exact tier, XLA path on CPU)
        N = pick_bucket(n)
        arr = jnp.asarray(pad_seqs([iseq], N))
        bpp, _ = mccaskill_bpp_batch(arr, jnp.asarray([n]), CT, N=N, contra=True)
        bpp = np.asarray(bpp[0])[:n, :n]
        # f64 truth
        obpp, _ = mccaskill_oracle_vec(iseq, uses_contra_model=True, fss=FSS)
        tp_b = np.array([bpp[i, j] for i, j in tp_set])
        tp_o = np.array([obpp[i, j] for i, j in tp_set])
        spans = np.array([j - i for i, j in tp_set])
        longr = spans >= 50
        m = {
            "cls": cls, "n": n, "true_pairs": len(tp_set),
            "prod_vs_f64_max_dBPP": float(np.abs(bpp - obpp).max()),
            "true_pair_bpp_mean": float(tp_b.mean()),
            "true_pair_bpp_median": float(np.median(tp_b)),
            "frac_true_pairs_bpp_gt_0.9": float((tp_b > 0.9).mean()),
            "frac_true_pairs_bpp_lt_0.5": float((tp_b < 0.5).mean()),
            "longrange_true_pair_bpp_mean": float(tp_b[longr].mean()) if longr.any() else None,
            "longrange_prod_minus_f64_mean": float((tp_b[longr] - tp_o[longr]).mean()) if longr.any() else None,
        }
        # fine gamma sweep, both estimators
        gammas = [2.0 ** (e / 2.0) for e in range(-8, 13)]
        cen, thr = {}, {}
        for g in gammas:
            pc, _ = centroid_fold(bpp, n, g)
            cen[g] = f1([tuple(p) for p in pc], tp_set)
            thr[g] = f1([tuple(p) for p in threshold_pairs(bpp, n, gamma=g)], tp_set)
        m["best_f1_centroid"] = round(max(cen.values()), 4)
        m["best_f1_threshold"] = round(max(thr.values()), 4)
        report["members"].append(m)
        print(json.dumps(m), flush=True)

with open(os.path.join(ROOT, 'eval_artifacts', 'hard_class_analysis.json'), 'w') as f:
    json.dump(report, f, indent=2)
print("wrote eval_artifacts/hard_class_analysis.json")
