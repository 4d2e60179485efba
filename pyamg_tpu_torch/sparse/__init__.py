"""Sparse containers and host converters of the port
(``sparse/matrix.py``)."""
