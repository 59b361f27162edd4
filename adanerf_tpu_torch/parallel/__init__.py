"""Scale-out: ray-data-parallel training (``mesh.py``) and ray-sharded
frames (``render.py``)."""
