"""Native code of the port: the CUDA kernels' build (``build.py``) and the
host IO library (``hostio.py``, ``ngmio.cpp``)."""
