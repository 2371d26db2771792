"""Dataset recipes of the port: twins of the JAX package's ``examples/``
(``abdomen_atlas``, ``aiib23_airway``, ``liver2017_ct``), each with the
same ``get_config`` and stages over the port's ``config``,
``data.planning``, ``data.preprocessing`` and ``train.Trainer``.

    python -m segmamba_tpu_torch.examples.liver2017_ct plan|preprocess|train
"""


def train(cfg, device="cuda"):
    """The recipes' ``train`` stage: the config's model and ``Trainer`` on
    ``device`` (the card by default), over the train / validation split of
    ``cfg.data.preprocessed_dir``."""
    from segmamba_tpu_torch.data import get_train_val_test_loader_from_train
    from segmamba_tpu_torch.train import Trainer

    model = cfg.build_model(device=device)
    trainer = Trainer(
        model, cfg.train.logdir, max_epochs=cfg.train.max_epochs,
        batch_size=cfg.train.batch_size, val_every=cfg.train.val_every,
        num_step_per_epoch=cfg.train.num_step_per_epoch,
        val_number=cfg.train.val_number,
        patch_size=tuple(cfg.train.patch_size),
        learning_rate=cfg.train.learning_rate, loss=cfg.train.loss,
        num_classes=cfg.model.out_chans, num_workers=cfg.train.num_workers,
        seed=cfg.train.seed, device=device)
    train_ds, val_ds, _ = get_train_val_test_loader_from_train(
        cfg.data.preprocessed_dir)
    trainer.train(train_ds, val_ds)
    return trainer
