"""Inference on the MRA likelihood (counterpart of ``pymra_tpu/infer``):
maximum likelihood so far."""
from pymra_torch.infer.mle import fit_mle, nelder_mead

__all__ = ["fit_mle", "nelder_mead"]
