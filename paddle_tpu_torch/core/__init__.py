"""Host-side native pieces of the port (``paddle_tpu/core``'s
``native_build.py`` and ``native/``): C++ built with ``g++`` at first use,
never at import."""
