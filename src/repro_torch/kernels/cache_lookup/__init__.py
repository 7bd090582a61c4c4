"""Hot-set rank/hit test (``search``) over the sorted cache ids."""
