"""Predefined well-known schemas and converter configs.

A copy of the reference package's `convert/schemas.py`.

Parity: the GDELT / AIS / NYC-taxi converter definitions shipped in
geomesa-tools resources [upstream, unverified] — the benchmark datasets'
attribute schemas, reduced to the benchmark-relevant columns. Column positions follow the public file formats:

- GDELT 1.0 events TSV (57 cols): GlobalEventID, day, actor/event codes,
  GoldsteinScale, NumMentions, ActionGeo lat/lon.
- AIS NMEA-decoded CSV (MarineCadastre layout): MMSI, BaseDateTime, LAT,
  LON, SOG, COG, Heading, VesselName.
- NYC TLC yellow-taxi CSV: pickup datetime + pickup lon/lat.
"""

from __future__ import annotations

from geomesa_tpu_torch.core.sft import SimpleFeatureType

GDELT_SPEC = (
    "GlobalEventID:String,EventCode:String,Actor1Name:String,Actor2Name:String,"
    "GoldsteinScale:Double,NumMentions:Integer,dtg:Date,*geom:Point:srid=4326"
)

GDELT_SFT = SimpleFeatureType.from_spec("gdelt", GDELT_SPEC)

# GDELT 1.0: $1=GlobalEventID $2=Day(yyyyMMdd) $7=Actor1Name $17=Actor2Name
# $27=EventCode $31=GoldsteinScale $32=NumMentions
# $54=ActionGeo_Lat $55=ActionGeo_Long  (1-based positions into the TSV;
# $40/$41 are Actor1Geo_Lat/Long — the event's *actor* location, not the
# action location the schema promises)
GDELT_CONVERTER = {
    "type": "delimited-text",
    "format": "TSV",
    "id-field": "$1",
    "fields": [
        {"name": "GlobalEventID", "transform": "$1::string"},
        {"name": "EventCode", "transform": "$27::string"},
        {"name": "Actor1Name", "transform": "withDefault($7, 'UNKNOWN')"},
        {"name": "Actor2Name", "transform": "withDefault($17, 'UNKNOWN')"},
        {"name": "GoldsteinScale", "transform": "toDouble($31, 0.0)"},
        {"name": "NumMentions", "transform": "toInt($32, 0)"},
        {"name": "dtg", "transform": "dateParse('yyyyMMdd', $2)"},
        {"name": "geom", "transform": "point($55, $54)"},
    ],
}

AIS_SPEC = (
    "MMSI:String,VesselName:String,SOG:Double,COG:Double,Heading:Double,"
    "dtg:Date,*geom:Point:srid=4326"
)

AIS_SFT = SimpleFeatureType.from_spec("ais", AIS_SPEC)

# MarineCadastre: $1=MMSI $2=BaseDateTime(ISO) $3=LAT $4=LON $5=SOG $6=COG
# $7=Heading $8=VesselName
AIS_CONVERTER = {
    "type": "delimited-text",
    "format": "CSV",
    "options": {"skip-lines": 1},
    "id-field": "concat($1, '-', $2)",
    "fields": [
        {"name": "MMSI", "transform": "$1::string"},
        {"name": "VesselName", "transform": "withDefault($8, '')"},
        {"name": "SOG", "transform": "toDouble($5, 0.0)"},
        {"name": "COG", "transform": "toDouble($6, 0.0)"},
        {"name": "Heading", "transform": "toDouble($7, 0.0)"},
        {"name": "dtg", "transform": "isoDateTime($2)"},
        {"name": "geom", "transform": "point($4, $3)"},
    ],
}

NYC_TAXI_SPEC = (
    "vendor:String,passengers:Integer,distance:Double,fare:Double,"
    "dtg:Date,*geom:Point:srid=4326"
)

NYC_TAXI_SFT = SimpleFeatureType.from_spec("nyctaxi", NYC_TAXI_SPEC)

# Classic yellow-taxi layout: $1=vendor $2=pickup_datetime $4=passenger_count
# $5=trip_distance $6=pickup_longitude $7=pickup_latitude $13=fare_amount
NYC_TAXI_CONVERTER = {
    "type": "delimited-text",
    "format": "CSV",
    "options": {"skip-lines": 1},
    "id-field": "uuid()",
    "fields": [
        {"name": "vendor", "transform": "$1::string"},
        {"name": "passengers", "transform": "toInt($4, 1)"},
        {"name": "distance", "transform": "toDouble($5, 0.0)"},
        {"name": "fare", "transform": "toDouble($13, 0.0)"},
        {"name": "dtg", "transform": "dateParse('yyyy-MM-dd HH:mm:ss', $2)"},
        {"name": "geom", "transform": "point($6, $7)"},
    ],
}

OSM_SPEC = (
    "osm_id:String,user:String,version:Integer,tags:String,"
    "dtg:Date,*geom:Point:srid=4326"
)

OSM_SFT = SimpleFeatureType.from_spec("osm", OSM_SPEC)

# OSM nodes flattened to CSV (osmconvert --csv layout):
# $1=id $2=lon $3=lat $4=user $5=version $6=timestamp(ISO) $7=tags
OSM_CONVERTER = {
    "type": "delimited-text",
    "format": "CSV",
    "id-field": "$1",
    "fields": [
        {"name": "osm_id", "transform": "$1::string"},
        {"name": "user", "transform": "withDefault($4, '')"},
        {"name": "version", "transform": "toInt($5, 1)"},
        {"name": "tags", "transform": "withDefault($7, '')"},
        {"name": "dtg", "transform": "isoDateTime($6)"},
        {"name": "geom", "transform": "point($2, $3)"},
    ],
}

TWITTER_SPEC = (
    "tweet_id:String,user_name:String,text:String,"
    "dtg:Date,*geom:Point:srid=4326"
)

TWITTER_SFT = SimpleFeatureType.from_spec("twitter", TWITTER_SPEC)

# Twitter API v1.1 statuses (one JSON object per line); geo-tagged tweets
# carry GeoJSON [lon, lat] in coordinates.coordinates
TWITTER_CONVERTER = {
    "type": "json",
    "id-field": "$tweet_id",
    "fields": [
        {"name": "tweet_id", "path": "$.id_str"},
        {"name": "user_name", "path": "$.user.screen_name",
         "transform": "withDefault($0, '')"},
        {"name": "text", "path": "$.text",
         "transform": "withDefault($0, '')"},
        {"name": "dtg", "path": "$.created_at",
         "transform": "dateParse('EEE MMM dd HH:mm:ss Z yyyy', $0)"},
        {"name": "lon", "path": "$.coordinates.coordinates.0"},
        {"name": "lat", "path": "$.coordinates.coordinates.1"},
        {"name": "geom", "transform": "point($lon, $lat)"},
    ],
}

WELL_KNOWN = {
    "gdelt": (GDELT_SFT, GDELT_CONVERTER),
    "ais": (AIS_SFT, AIS_CONVERTER),
    "nyctaxi": (NYC_TAXI_SFT, NYC_TAXI_CONVERTER),
    "osm": (OSM_SFT, OSM_CONVERTER),
    "twitter": (TWITTER_SFT, TWITTER_CONVERTER),
}
