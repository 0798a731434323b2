"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` on the GPU it is started on.
Everything that belongs to one configuration, traffic mix, per-layer
metric or cell is a file of its own, found by the name ``BENCHMARK.json``
gives it:

- ``configs/<config>.json``: the sizes as run, their public source, the
  keys changed from it (``reduced``) and the sizes set here (``assumed``);
- ``archs/<model_type>.py``, by the configuration's ``model_type``:
  everything particular to an architecture, so that a new one comes as
  new files. It declares ``port_config(conf)`` (the port's
  ``ArchConfig``), ``REFERENCE`` (the name of its plain float32 forward,
  ``reference/<REFERENCE>.py``), ``batch_work(conf, traffic)`` (the work
  of a batch from the published shapes, which the metric readers take),
  ``SPREAD_LEAVES`` (the weights that carry the cell's logit spread) and
  ``KERNEL_CHECKS`` (the kernel numbers its path can give); the contract
  in full is ``archs/__init__.py``'s;
- ``traffic/<traffic>.json``: the parameters the generator in
  ``traffic.py`` reads;
- ``metrics/<metric>.py``: a reader, ``read(ctx)``, that returns the
  metric or None where it finds nothing to read;
- ``limits/<cell>.json``: the limits of the numbers that decide
  ``correct``, the spread of the seeded weights' attention logits they
  were set with (``weights.make``), and the readings they were set from.

The yardstick lives here too: the work counts (``work.py``), the plain
float32 references (``reference/``), the comparison (``compare.py``) and
the reading of the profiler's trace (``trace.py``). Nothing here imports
JAX or the JAX package, and ``reference/`` imports nothing of the port.
``toy_mla/`` is a toy architecture that the CPU tests add to a copy of
the layout as files.
"""
