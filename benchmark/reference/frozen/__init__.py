"""Parts of ``metdetpy_tpu_torch`` frozen at commit 1a4e1bf, which the plain
reference calls: the plain PyTorch ops of the M3 step and the step itself
as a function of its carries (``f32``, ``filters``, ``windows``, ``hough``,
``kernels``: the plain versions of the four CUDA kernels, ``step``), the
YOLOv5s modules (``yolov5``) and the host collector (``collector``,
``series``, ``exporter``, ``records``, ``utils``). Nothing here imports the
program, loads a file of it or builds a kernel.
"""
