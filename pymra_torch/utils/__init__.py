from pymra_torch.utils import checkpoint, health, profiling
from pymra_torch.utils.locations import gen_clusters, gen_locations, gen_locations_2d
from pymra_torch.utils.logging import configure as configure_logging
from pymra_torch.utils.logging import get_logger
from pymra_torch.utils.profiling import PhaseTimer
from pymra_torch.utils.scoring import kl_divergence, logscore, mse, rmse
from pymra_torch.utils.simulate import (
    make_observations,
    simulate_grf,
    simulate_grf_grid,
)

__all__ = ["checkpoint", "health", "profiling", "PhaseTimer",
           "configure_logging", "get_logger", "gen_locations",
           "gen_locations_2d", "gen_clusters", "rmse", "mse",
           "kl_divergence", "logscore", "simulate_grf", "simulate_grf_grid",
           "make_observations"]
