"""The benchmark of ``beluga_tpu_torch``: fleets of Monte Carlo
localization filters on one NVIDIA H100 (``run.py`` runs one cell; the
layout is in ``harness.py``).  Nothing here imports JAX or the JAX
package."""
