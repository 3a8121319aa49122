from .visualization import save_predictions_csv

__all__ = ["save_predictions_csv"]
