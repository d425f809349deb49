"""Reference solvers of the port: a float64 NumPy SPH oracle
(``sph_numpy``), a copy of ``lpe_tpu/oracle/sph_numpy.py``."""
