from .bindings import (
    UnportedFormat,
    batch_load_resize_u8,
    batch_resize_u8,
    decode_image,
    decode_png,
    png_info,
    resize_u8,
    unported_format,
)

__all__ = ["UnportedFormat", "batch_load_resize_u8", "batch_resize_u8", "decode_image",
           "decode_png", "png_info", "resize_u8", "unported_format"]
