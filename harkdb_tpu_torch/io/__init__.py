"""File loaders that need no third-party package: the native CSV reader."""
