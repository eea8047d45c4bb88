"""The benchmark's own code: what ``run.py`` drives, and what the drivers,
the per-layer readers and the rooflines share. It imports the program
(``ppst_tpu_torch``) only inside functions (``program``, ``sites``,
``faults`` and the drivers)."""
