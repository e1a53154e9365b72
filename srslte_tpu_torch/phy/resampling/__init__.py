from .resampler import interp_linear_cf, resample_arb, resample_fft  # noqa: F401
