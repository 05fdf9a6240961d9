"""Training loops built on the renderer (``models/dmesh.py``)."""
