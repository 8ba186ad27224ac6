"""Dataset and metadata catalogs (reference: vidgen/data/catalog.py:12-211)."""

import types
from typing import Callable, Dict, List


class DatasetCatalog:
    """name -> zero-arg loader function returning list[dict]."""

    _REGISTERED: Dict[str, Callable] = {}

    @staticmethod
    def register(name: str, func: Callable) -> None:
        assert callable(func), "DatasetCatalog.register needs a callable"
        assert name not in DatasetCatalog._REGISTERED, f"Dataset '{name}' already registered"
        DatasetCatalog._REGISTERED[name] = func

    @staticmethod
    def get(name: str) -> List[dict]:
        try:
            f = DatasetCatalog._REGISTERED[name]
        except KeyError:
            raise KeyError(
                f"Dataset '{name}' is not registered! Available: "
                f"{', '.join(sorted(DatasetCatalog._REGISTERED))}")
        return f()

    @staticmethod
    def list() -> List[str]:
        return list(DatasetCatalog._REGISTERED)

    @staticmethod
    def clear() -> None:
        DatasetCatalog._REGISTERED.clear()


class Metadata(types.SimpleNamespace):
    name: str = "N/A"

    def set(self, **kwargs) -> "Metadata":
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self


class MetadataCatalog:
    _M: Dict[str, Metadata] = {}

    @staticmethod
    def get(name: str) -> Metadata:
        assert len(name)
        if name not in MetadataCatalog._M:
            MetadataCatalog._M[name] = Metadata(name=name)
        return MetadataCatalog._M[name]
