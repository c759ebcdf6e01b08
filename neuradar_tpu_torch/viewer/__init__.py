"""Viewer helpers of the port (``overlays.project_points``, which the texture baker uses)."""
