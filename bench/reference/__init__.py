"""The plain float32 reference of the benchmark's configurations
(``transformer.py``) and of the uncertainty scores (``scores.py``)."""
