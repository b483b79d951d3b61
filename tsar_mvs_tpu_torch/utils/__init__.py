"""I/O codecs, scene readers and synthetic data (the port's own copies of
``tsar_mvs_tpu.utils``)."""
