"""Device-side (PyTorch/CUDA) compute of MetDetPy-TPU's port: the M3
path's filters, window statistics, Hough extraction and the four
hand-written CUDA kernels (``kernels``); the stackers and the device MFNR
of clip export (``stack``, ``stack_device``)."""
