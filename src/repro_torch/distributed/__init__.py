"""Device meshes of the port: a mesh of torch devices driven by one
process, with per-shard collectives written as plain loops."""
