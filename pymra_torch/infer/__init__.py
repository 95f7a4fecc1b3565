"""Inference on the MRA likelihood (counterpart of ``pymra_tpu/infer``):
maximum likelihood, the samplers (HMC, NUTS, ADVI, SMC) and their
diagnostics."""
from pymra_torch.infer.advi import ADVIResult, advi
from pymra_torch.infer.diagnostics import ess, split_rhat
from pymra_torch.infer.hmc import HMCResult, hmc
from pymra_torch.infer.mle import fit_mle, nelder_mead
from pymra_torch.infer.nuts import NUTSResult, nuts
from pymra_torch.infer.smc import SMCResult, smc

__all__ = [
    "fit_mle",
    "nelder_mead",
    "hmc",
    "HMCResult",
    "nuts",
    "NUTSResult",
    "advi",
    "ADVIResult",
    "smc",
    "SMCResult",
    "split_rhat",
    "ess",
]
