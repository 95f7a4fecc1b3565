from pymra_torch.utils.locations import gen_locations, gen_locations_2d

__all__ = ["gen_locations", "gen_locations_2d"]
