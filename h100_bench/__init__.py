"""The H100 benchmark of ``nadavca_tpu_torch``: the card's share of the SNP job.

``run.py`` is the entry; everything a cell needs is found by name: the
configuration under ``configs/``, the traffic mix under ``traffic/`` and
one reader per per-layer metric under ``layers/``. The generator
(``gen.py``) and the plain reference (``reference.py``) import nothing of the
program.
"""
