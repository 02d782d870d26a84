"""The plain float64 reference of the scan: PLINK decoding, covariate
residualization, standardization, Pearson r, the t statistic and its
two-sided -log10 p.  It imports neither ``jax``, ``repro`` nor anything of
``repro_torch``, and takes only the raw inputs (the ``.bed`` file and the
phenotype and covariate tables) that the port is handed."""
from gwasbench.reference.ols import PanelReference, neglog10p, t2_for_nlp, decode_bed

__all__ = ["PanelReference", "neglog10p", "t2_for_nlp", "decode_bed"]
