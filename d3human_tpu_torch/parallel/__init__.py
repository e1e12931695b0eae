"""The parallel paths: the frame-parallel seq stage and the data-parallel
step over ``torch.distributed`` (``frames.py``) on a 1-D process layout
(``mesh.py``)."""
