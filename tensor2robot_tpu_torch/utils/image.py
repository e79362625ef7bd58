"""Image encoding helpers for replay writing: the actor side's import
surface over `data.codec` (counterpart of `tensor2robot_tpu.utils.image`)."""

from tensor2robot_tpu_torch.data.codec import (  # noqa: F401
    decode_image,
    decode_image_batch,
    encode_image,
    maybe_recompress_jpeg,
)

__all__ = ["encode_image", "decode_image", "decode_image_batch",
           "maybe_recompress_jpeg"]
