"""Synthetic geo-captions for CLIP contrastive pretraining (the port's
copy of geoguessr_ai_tpu/train/captions.py, without pandas).

Captions combine country / region / town (with "the"-prefixed countries),
the Köppen climate zone, the driving side and the capture month, each
included at random so CLIP sees varied descriptions of similar images.
Randomness comes from a passed-in ``random.Random``, drawn in the JAX
module's order, so a seed gives the same caption stream in both packages.

``enrich_rows`` is ``enrich_dataframe`` over a sequence of row mappings.
Sampling the Köppen raster needs rasterio and pyproj, which the port's
machines do not have: a raster raises ``NotImplementedError`` (ROADMAP
Queue 1 item 15); rows that carry a ``climate_zone`` already caption it.
"""

from __future__ import annotations

import math
import random
from typing import Dict, Iterable, List, Mapping, Optional

# Köppen-Geiger climate-zone descriptions (reference backend/metadata.py:9-40)
CLIMATE_DICT: Dict[int, str] = {
    1: "a tropical rainforest climate",
    2: "a tropical monsoon climate",
    3: "a tropical savanna climate",
    4: "an arid, hot desert climate",
    5: "an arid, cold desert climate",
    6: "a hot, semi-arid climate",
    7: "a cold, semi-arid climate",
    8: "a Mediterranean climate with a hot summer",
    9: "a Mediterranean climate with a warm summer",
    10: "a Mediterranean climate with a cold summer",
    11: "a humid subtropical monsoon climate",
    12: "a temperate oceanic monsoon climate",
    13: "a subpolar oceanic monsoon climate",
    14: "a humid subtropical climate",
    15: "a temperate oceanic climate",
    16: "a subpolar oceanic climate",
    17: "a Mediterranean humid continental climate with a hot summer",
    18: "a Mediterranean humid continental climate with a warm summer",
    19: "a Mediterranean subarctic climate with a cold summer",
    20: "a Mediterranean humid continental climate with a warm summer",
    21: "a humid continental monsoon climate with a hot summer",
    22: "a humid continental monsoon climate with a warm summer",
    23: "a subarctic monsoon climate",
    24: "an extremely cold subarctic monsoon climate",
    25: "a humid continental climate with a hot summer",
    26: "a humid continental climate with a warm summer",
    27: "a subarctic climate",
    28: "an extremely cold subarctic climate",
    29: "a polar tundra climate",
    30: "a polar ice cap climate",
}

MONTHS: Dict[str, str] = {
    "01": "January", "02": "February", "03": "March", "04": "April",
    "05": "May", "06": "June", "07": "July", "08": "August",
    "09": "September", "10": "October", "11": "November", "12": "December",
}

#: Countries/territories that read naturally with a "the" prefix
#: (reference pretrain_idun.py:29-52).
THE_COUNTRIES = frozenset(
    {
        "Bahamas", "British Virgin Islands", "Cayman Islands",
        "Cocos Islands", "Comoros", "Cook Islands", "Falkland Islands",
        "Faroe Islands", "French Southern Territories", "Maldives",
        "Marshall Islands", "Netherlands", "Northern Mariana Islands",
        "Paracel Islands", "Philippines", "Pitcairn Islands", "Seychelles",
        "Solomon Islands", "Spratly Islands", "Turks and Caicos Islands",
        "United Arab Emirates", "United States",
    }
)

#: Left-hand-traffic countries (reference pretrain/leftdrive_countries.py).
LEFT_DRIVE = frozenset(
    {
        "Australia", "Bangladesh", "Bermuda", "Bhutan", "Botswana",
        "Christmas Island", "Cocos Islands", "Eswatini", "Hong Kong",
        "India", "Indonesia", "Ireland", "Isle of Man", "Japan", "Jersey",
        "Kenya", "Lesotho", "Macau", "Malaysia", "Malta", "Namibia",
        "Nepal", "New Zealand", "Pitcairn Islands", "Singapore",
        "South Africa", "Sri Lanka", "Thailand", "Uganda",
        "United Kingdom", "United States Virgin Islands", "England",
        "Wales", "Scotland",
    }
)


def drives_on_right(country: Optional[str]) -> Optional[bool]:
    if not country:
        return None
    return country not in LEFT_DRIVE


def _valid(x) -> bool:
    if x is None or (isinstance(x, float) and math.isnan(x)):
        return False
    return str(x).strip() != ""


def select_caption(
    sample: Dict,
    rng: Optional[random.Random] = None,
) -> str:
    """Build one randomized caption from an enriched sample dict.

    Expected keys (all optional): lat, lon, capture_date, country, region,
    town, climate_zone (description string), drive_right (bool), month
    (name).  Reference behavior: pretrain_idun.py:71-174.
    """
    rng = rng or random
    country = sample.get("country")
    if country == "United States Of America":
        country = "United States"
    country_str = f"the {country}" if country in THE_COUNTRIES else country

    region = sample.get("region")
    town = sample.get("town")

    if _valid(country_str):
        region_str = (
            f"in the region of {region} "
            if _valid(region) and rng.random() > 0.4
            else ""
        )
        town_str = (
            f"close to the town of {town} "
            if _valid(town) and rng.random() > 0.6
            else ""
        )
        location = (
            f"A Street View photo {town_str}{region_str}in {country_str}."
        )
    elif _valid(sample.get("lat")) and _valid(sample.get("lon")):
        location = (
            f"A Street View photo taken around latitude "
            f"{float(sample['lat']):.3f}, longitude "
            f"{float(sample['lon']):.3f}."
        )
    else:
        location = "A Street View photo."

    climate = sample.get("climate_zone")
    climate_part = (
        f" This location has {str(climate).lower()}."
        if _valid(climate) and rng.random() > 0.6
        else ""
    )

    drive_right = sample.get("drive_right")
    drive_part = ""
    if (
        drive_right is not None
        and _valid(country_str)
        and climate_part == ""
        and rng.random() > 0.7
    ):
        side = "right" if drive_right else "left"
        drive_part = (
            f" In this location, people drive on the {side} side of the road."
        )

    month_part = ""
    month = sample.get("month")
    capture_date = sample.get("capture_date")
    if _valid(month) and rng.random() > 0.7:
        month_part = f" The photo was taken in {month}."
    elif _valid(capture_date) and rng.random() > 0.7:
        code = str(capture_date)[5:7]
        month_part = f" The photo was taken in {MONTHS.get(code, code)}."

    extras = [climate_part, drive_part, month_part]
    rng.shuffle(extras)
    return (location + "".join(extras)).strip()


def enrich_rows(rows: Iterable[Mapping], geocell_manager=None,
                climate_raster: Optional[str] = None) -> List[Dict]:
    """Copies of ``rows`` (mappings of one image each) with the caption
    metadata of the JAX ``enrich_dataframe``: ``month`` from
    ``capture_date`` (``batch_date`` when no row has one), and with a
    geocell manager (anything with ``get_geocell_id({"latitude",
    "longitude"}) -> (cell, country, region)``) ``cell``, ``country``,
    ``region`` and ``drive_right``."""
    if climate_raster is not None:
        raise NotImplementedError(
            "sampling the Köppen climate raster needs rasterio and pyproj, "
            "which the port does not use; it waits for the port's own "
            "raster reader (ROADMAP Queue 1 item 15).  Give rows a "
            "climate_zone instead")
    out = [dict(r) for r in rows]
    date_col = ("capture_date" if any("capture_date" in r for r in out)
                else "batch_date")
    if any(date_col in r for r in out):
        for r in out:
            # a DataFrame's str() of a missing value has no month either
            r["month"] = MONTHS.get(str(r.get(date_col))[5:7], "")
    if geocell_manager is not None:
        for r in out:
            cell, country, region = geocell_manager.get_geocell_id(
                {"latitude": r["lat"], "longitude": r["lon"]})
            r.update(cell=cell, country=country, region=region,
                     drive_right=drives_on_right(country))
    return out
