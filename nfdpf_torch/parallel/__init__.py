"""Device meshes over ``torch.distributed``: the ('data', 'particle') rank
grid, its process groups and the collectives the filter needs."""
