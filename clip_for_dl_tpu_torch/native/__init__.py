from .bindings import (
    batch_load_resize_u8,
    batch_resize_u8,
    decode_png,
    png_info,
    resize_u8,
)

__all__ = ["batch_load_resize_u8", "batch_resize_u8", "decode_png", "png_info", "resize_u8"]
