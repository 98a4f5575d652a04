"""Host C++ code of the port, built with g++ at first use and bound with
ctypes (``build.py``)."""
