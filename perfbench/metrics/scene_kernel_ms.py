"""Device time of the scene kernel (``ops/scene.py:scene_render`` →
``csrc/scene.cu``, kernels named ``scene_kernel*``) a step, ms."""

from perfbench.trace import kernel_ms


def read(rec):
    return kernel_ms(rec["trace"], "scene_kernel")
