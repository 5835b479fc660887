"""Single-device counterparts of ``depthg_tpu/parallel`` (the mesh is multi-GPU work)."""
