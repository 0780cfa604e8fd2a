"""Command-line drivers: train_predict (train, predict and verify),
predict (long rollouts of a trained experiment), export_model (serving
artifacts, single, member-stacked or SWAG-sampled), serve (HTTP over an
artifact) and finetune_swag (SWAG fine-tuning, ensemble predictions and
their probabilistic verification)."""
