"""Visualization: the self-contained HTML motion player (own copy of
``diffsheg_tpu/viz``)."""

from diffsheg_tpu_torch.viz.player import export_bvh_player, export_player_html

__all__ = ["export_bvh_player", "export_player_html"]
