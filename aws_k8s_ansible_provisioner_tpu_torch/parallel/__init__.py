"""Device meshes and the sharded serving cache (sequence-parallel serving)."""
