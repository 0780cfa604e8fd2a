"""Command-line drivers: train_predict (train, predict and verify),
predict (long rollouts of a trained experiment), export_model (serving
artifacts) and serve (HTTP over an artifact)."""
