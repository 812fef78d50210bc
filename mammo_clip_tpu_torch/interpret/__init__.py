from .factor import FactorMapper, attribute_embeddings, factor_loss

__all__ = ["FactorMapper", "attribute_embeddings", "factor_loss"]
