"""Plain PyTorch enhancement ops on float32 [..., H, W] tensors in [0, 1].

Each op has the semantics and f32 operation order of its namesake in
``mies_tpu.ops``, and is the plain version its kernel is held against.
"""
