"""One driver a traffic mix's entry point: ``drivers/<entry>.py`` defines
``Cell``."""
