PROJECT_NAME = "MetDetPy-TPU"
# Version string mirrors the reference release we target for capability
# parity (reference: MetLib/utils.py:20, V2.4.0), with a -tpu suffix.
VERSION = "V2.4.0-tpu.1"
