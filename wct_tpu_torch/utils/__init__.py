"""Host-side utilities: ``device`` (device choice, f32 numerics policy)
and ``images`` (image IO and crops, needs Pillow)."""
