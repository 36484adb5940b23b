"""rna_algos_tpu: an RNA bioinformatics framework in JAX.

Brand-new JAX/XLA implementation of the capability surface of heartsh/rna-algos
(Rust, CPU): McCaskill base-pairing-probability partition functions under the
Turner 2004 and CONTRAfold v2.02 models, the Durbin pair-HMM posterior match
probabilities under CONTRAlign v2.01 scores, and gamma-centroid (MEA) secondary
structure estimation — redesigned as dense anti-diagonal wavefront dynamic
programs batched over device meshes.

Layers (see SURVEY.md for the reference layer map):
  params/    scoring tables + parsers            (reference L0)
  numerics/  exact CONTRAfold log-space LSE      (reference utils.rs:579-655)
  ops/       wavefront DP engines                (reference L2 inner loops)
  models/    mccaskill / durbin / centroid APIs  (reference L2 facades)
  parallel/  mesh + batch sharding               (reference L3 thread pool)
  utils/     IO and formats                      (reference C18)
  cli/       drop-in command line tools          (reference C12-C15)
  eval/      accuracy statistics pipeline        (reference C21)
"""

__version__ = "0.1.0"

from . import constants

__all__ = ["constants", "__version__"]


def __getattr__(name):
    # lazy subpackage access without importing jax at package import time
    if name in ("models", "params", "ops", "parallel", "utils", "eval", "cli", "numerics"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
