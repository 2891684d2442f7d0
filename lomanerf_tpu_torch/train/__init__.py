"""Training and its drivers: ``optim`` (LomaAdam, loma_sgd), ``steps``
(the single-device NeRF and image-fit steps), ``checkpoint``
(CheckpointManager and params fixtures), ``logging_utils`` (JSONL metrics,
PNG writer), ``train_nerf`` (the NeRF driver), ``fit_image`` (the 2D image
field driver) and ``make_video`` (the orbit renderer)."""
