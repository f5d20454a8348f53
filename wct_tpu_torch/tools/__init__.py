"""Measurement tools that run on the card; the offline tools: ``make_bundle``,
the converters ``convert_t7`` and ``convert_tf_ckpt``, the output
comparator and the float64 ``oracle``, which run on the host, and
``normalize_encoder``, which runs the encoder on the card (or the CPU)."""
