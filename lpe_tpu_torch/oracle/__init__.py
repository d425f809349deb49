"""Reference solvers of the port: a float64 NumPy SPH oracle
(``sph_numpy``, a copy of ``lpe_tpu/oracle/sph_numpy.py``) and the ctypes
binding of the native C++ reference engines (``native``, a copy of
``lpe_tpu/oracle/native.py`` that builds its library into ``build/``)."""
