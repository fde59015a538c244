"""Node-dimension sharding of the solve over a device mesh
(parallel/mesh.py)."""
