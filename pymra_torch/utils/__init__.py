from pymra_torch.utils import health
from pymra_torch.utils.locations import gen_clusters, gen_locations, gen_locations_2d
from pymra_torch.utils.simulate import (
    make_observations,
    simulate_grf,
    simulate_grf_grid,
)

__all__ = ["health", "gen_locations", "gen_locations_2d", "gen_clusters",
           "simulate_grf", "simulate_grf_grid", "make_observations"]
