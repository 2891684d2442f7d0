"""Training and its drivers: ``optim`` (LomaAdam, loma_sgd), ``steps``
(the single-device train step), ``checkpoint`` (CheckpointManager and params
fixtures), ``logging_utils`` (JSONL metrics, PNG writer), ``train_nerf``
(the NeRF driver) and ``make_video`` (the orbit renderer)."""
