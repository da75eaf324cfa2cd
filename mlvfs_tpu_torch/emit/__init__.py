from .dng import build_dng_header, dng_header_size, dng_image_size, dng_file_size  # noqa: F401
from .wav import build_wav, wav_size  # noqa: F401
from .gif import build_gif, gif_size  # noqa: F401
